"""Port parity: the port's quantized KV cache (acestep_tpu_torch/serving/
kv_cache.py) against the JAX package's, on the CPU.

Quantization is held bit-exact (same f32 operations, round half to even for
int8, round to nearest even into float8_e4m3fn); grow / broadcast / advance
are layout operations and are held exact too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.serving import kv_cache as jkvc
from acestep_tpu_torch.serving import kv_cache as tkvc


def _x(seed, shape=(3, 2, 5, 128), scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: scale 0, values 0
    x[0, 0, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # halfway cases for the rounding
    return x


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_bit_exact(kv_dtype, dtype, monkeypatch):
    monkeypatch.setenv("ACESTEP_TPU_KV_DTYPE", kv_dtype)
    x = _x(0)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    jq, js = jkvc.quantize_kv(jx)
    tq, ts = tkvc.quantize_kv(tx, kv_dtype)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if kv_dtype == "int8":
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    else:
        assert tq.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))
    back_j = np.asarray(jkvc.dequantize_kv(jq, js, jnp.float32))
    np.testing.assert_array_equal(tkvc.dequantize_kv(tq, ts, torch.float32).numpy(), back_j)


def test_init_cache_layout():
    c = tkvc.init_cache(3, 2, 4, 256, 128, device="cpu")
    assert tuple(c.k.shape) == (3, 2, 4, 256, 128) and c.k.dtype == torch.int8
    assert tuple(c.k_scale.shape) == (3, 2, 4, 256) and c.k_scale.dtype == torch.float32
    assert tuple(c.length.shape) == (2,) and c.length.dtype == torch.int32
    assert c.max_len == 256 and c.kv_dtype == "int8"
    assert tkvc.init_cache(1, 1, 1, 128, 128, "fp8").k.dtype == torch.float8_e4m3fn
    with pytest.raises(ValueError, match="kv_dtype"):
        tkvc.init_cache(1, 1, 1, 128, 128, "int4")
    assert [tkvc.round_len(n) for n in (1, 128, 129, 1281)] == \
        [jkvc.round_len(n) for n in (1, 128, 129, 1281)] == [128, 128, 256, 1408]


def _pair(seed, layers=2, batch=1, t=128):
    """The same random cache in both packages."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (layers, batch, 2, t, 128)).astype(np.int8)
    v = rng.integers(-127, 128, (layers, batch, 2, t, 128)).astype(np.int8)
    ks = rng.random((layers, batch, 2, t)).astype(np.float32)
    vs = rng.random((layers, batch, 2, t)).astype(np.float32)
    length = np.asarray([37] * batch, np.int32)
    j = jkvc.KVCache(*(jnp.asarray(a) for a in (k, v, ks, vs, length)))
    t_ = tkvc.KVCache(*(torch.from_numpy(a.copy()) for a in (k, v, ks, vs, length)))
    return j, t_


def _same(j, t_):
    for f in ("k", "v", "k_scale", "v_scale", "length"):
        np.testing.assert_array_equal(getattr(t_, f).numpy(), np.asarray(getattr(j, f)), f)


def test_grow_broadcast_advance_match():
    j, t_ = _pair(1)
    _same(jkvc.grow_cache(j, 384), tkvc.grow_cache(t_, 384))
    assert tkvc.grow_cache(t_, 128) is t_                 # no shrink, no copy
    jb, tb = jkvc.broadcast_cache(j, 3), tkvc.broadcast_cache(t_, 3)
    _same(jb, tb)
    assert tkvc.broadcast_cache(tb, 3) is tb
    with pytest.raises(ValueError):
        tkvc.broadcast_cache(tb, 5)
    active = np.asarray([True, False, True])
    _same(jkvc.advance(jb, jnp.asarray(active)), tkvc.advance(tb, torch.from_numpy(active)))


def test_clone_is_independent():
    _, t_ = _pair(2)
    c = t_.clone()
    c.k[0, 0, 0, 0, 0] += 1
    c.length += 1
    assert int(t_.k[0, 0, 0, 0, 0]) != int(c.k[0, 0, 0, 0, 0])
    assert int(t_.length[0]) == 37
