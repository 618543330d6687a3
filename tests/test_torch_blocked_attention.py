"""Port parity of the blocked self-attention (acestep_tpu_torch.ops.blocked_attention)
and of the DiT's dispatch to it, against the JAX package on the CPU.

``banded_attention`` and ``flash_attention`` take the same numpy-drawn q, k, v
as the JAX functions.  Tolerances, from the dtype: f32 inputs differ only by
f32 summation order (1e-5 of the output's peak); bf16 inputs by at most one
bf16 step of the output's peak (2^-7 of it), since a summation-order
difference can flip the rounding of an output or of a bf16 probability.

``dit.forward`` and ``dit.lyric_encoder`` run with the threshold lowered on
both sides (``ACESTEP_TPU_BLOCKED_ATTN_MIN`` for the JAX package, the port's
``BLOCKED_ATTN_MIN``), so the tiny models take the banded and flash path, and
are held to the models' bf16 bound (tests/test_torch_models.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.models import dit as jdit
from acestep_tpu.ops import blocked_attention as jba
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.ops import blocked_attention as tba
from acestep_tpu_torch.ops.nn import attention, make_attention_mask
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from tests.test_pipeline import TINY_DIT
from tests.test_torch_models import assert_bf16_close, jax_params, port_cfg, to_np

F32_REL = 1e-5
BF16_REL = 2.0 ** -7

# (T, window, block_k, padded keys): T not a multiple of the window, T of
# exactly one block, several flash blocks with a ragged last one
CASES = [(37, 8, 16, 0), (16, 16, 16, 0), (40, 8, 16, 5), (70, 16, 32, 11)]


def _qkv(t, rep, dtype, seed):
    rng = np.random.default_rng(seed)
    b, hkv, d = 2, 2, 16
    q = rng.standard_normal((b, hkv * rep, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    if dtype == "bf16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    return q, k, v


def _valid(t, n_pad):
    if not n_pad:
        return None
    valid = np.ones((2, t), np.int32)
    valid[1, t - n_pad:] = 0       # item 1's keys padded, item 0 whole
    return valid


def _to_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _assert_close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    rel = BF16_REL if dtype == "bf16" else F32_REL
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("t,window,block_k,n_pad", CASES)
def test_banded_and_flash_match_jax(t, window, block_k, n_pad, rep, dtype):
    q, k, v = _qkv(t, rep, dtype, seed=t * 10 + rep)
    valid = _valid(t, n_pad)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jq, jk, jvv = (_to_jax(x, dtype) for x in (q, k, v))
    tq, tk, tvv = (_to_torch(x, dtype) for x in (q, k, v))

    ref = jba.banded_attention(jq, jk, jvv, window=window, kv_valid=jv)
    got = tba.banded_attention(tq, tk, tvv, window, tv)
    assert got.dtype == tq.dtype
    _assert_close(got, ref, dtype)

    ref = jba.flash_attention(jq, jk, jvv, kv_valid=jv, block_k=block_k)
    got = tba.flash_attention(tq, tk, tvv, tv, block_k=block_k)
    assert got.dtype == tq.dtype
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("t,window,n_pad", [(37, 8, 0), (40, 8, 5)])
def test_banded_equals_dense_sliding_attention(t, window, n_pad):
    """The band computes dense attention under the sliding mask, f32 inputs."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(t, 2, "f32", seed=3))
    valid = _valid(t, n_pad)
    tv = None if valid is None else torch.from_numpy(valid)
    dense = attention(q, k, v, make_attention_mask(t, t, kv_valid=tv, sliding_window=window))
    banded = tba.banded_attention(q, k, v, window, tv)
    assert (banded - dense).abs().max() <= F32_REL * dense.abs().max()


def test_threshold_dispatch():
    assert tba.BLOCKED_ATTN_MIN == jba.blocked_attn_threshold() == 1536
    assert not tba.use_blocked_attention(1535) and tba.use_blocked_attention(1536)


@pytest.fixture(scope="module")
def dit_params():
    dp, _, _ = jax_params(seed=11)
    tp = precast_quant_scales(tdit.fuse_params(tdit.stack_params(
        weights.from_jax_numpy(to_np(dp)))))
    return dp, tp


@pytest.fixture
def blocked_from_8(monkeypatch):
    """Both packages take the blocked path from 8 tokens; the port's banded and
    flash functions count their calls."""
    monkeypatch.setenv(jba.BLOCKED_ATTN_MIN_ENV, "8")
    monkeypatch.setattr(tba, "BLOCKED_ATTN_MIN", 8)
    calls = {"banded": 0, "flash": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tdit, "banded_attention", spy("banded", tba.banded_attention))
    monkeypatch.setattr(tdit, "flash_attention", spy("flash", tba.flash_attention))
    return calls


def test_dit_forward_blocked_matches_jax(dit_params, blocked_from_8):
    dp, tp = dit_params
    rng = np.random.default_rng(12)
    b, t, lc = 2, 40, 10
    cfg = TINY_DIT
    x = rng.standard_normal((b, t, cfg.audio_acoustic_hidden_dim)).astype(np.float32)
    ctx = rng.standard_normal((b, t, cfg.context_dim)).astype(np.float32)
    enc = rng.standard_normal((b, lc, cfg.hidden_size)).astype(np.float32)
    attn_mask = (np.arange(t)[None] < np.array([[40], [27]])).astype(np.int32)
    enc_mask = (np.arange(lc)[None] < 7).astype(np.int32).repeat(b, 0)
    ts = np.full((b,), 0.7, np.float32)

    @jax.jit
    def jax_step(p, x, ts, ctx, enc, attn_mask, enc_mask):
        kv = jdit.compute_all_cross_kv(p, cfg, jdit.compute_condition(p, cfg, enc))
        return jdit.forward(p, cfg, x, ts, ts, context_latents=ctx, attn_mask=attn_mask,
                            encoder_attn_mask=enc_mask, cross_kv_cache=kv)

    ref = np.asarray(jax_step(jdit.fuse_params(jdit.stack_params(dp)),
                              jnp.asarray(x, jnp.bfloat16), jnp.asarray(ts), jnp.asarray(ctx),
                              jnp.asarray(enc, jnp.bfloat16), jnp.asarray(attn_mask),
                              jnp.asarray(enc_mask)).astype(jnp.float32))
    pcfg = port_cfg(cfg)
    tenc = tdit.compute_condition(tp, pcfg, torch.from_numpy(enc).bfloat16())
    got = tdit.forward(tp, pcfg, torch.from_numpy(x).bfloat16(), torch.from_numpy(ts),
                       torch.from_numpy(ts), torch.from_numpy(ctx),
                       tdit.compute_all_cross_kv(tp, pcfg, tenc),
                       attn_mask=torch.from_numpy(attn_mask),
                       encoder_attn_mask=torch.from_numpy(enc_mask))
    n_layers = cfg.num_hidden_layers
    n_sliding = sum(lt == "sliding_attention" for lt in cfg.layer_types[:n_layers])
    assert blocked_from_8 == {"banded": n_sliding, "flash": n_layers - n_sliding}
    assert np.abs(ref).max() > 0.1
    for i, n in enumerate((40, 27)):
        assert_bf16_close(got.float()[i, :n], ref[i, :n])


def test_lyric_encoder_blocked_matches_jax(dit_params, blocked_from_8):
    dp, tp = dit_params
    rng = np.random.default_rng(13)
    b, l = 2, 24
    emb = rng.standard_normal((b, l, TINY_DIT.text_hidden_dim)).astype(np.float32)
    mask = (np.arange(l)[None] < np.array([[24], [15]])).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, e, m: jdit.lyric_encoder(p, TINY_DIT, e, m))(
        dp, jnp.asarray(emb, jnp.bfloat16), jnp.asarray(mask)).astype(jnp.float32))
    got = tdit.lyric_encoder(tp, port_cfg(TINY_DIT), torch.from_numpy(emb).bfloat16(),
                             torch.from_numpy(mask))
    n = TINY_DIT.num_lyric_encoder_hidden_layers
    assert blocked_from_8["banded"] + blocked_from_8["flash"] == n
    for i, v in enumerate((24, 15)):
        assert_bf16_close(got.float()[i, :v], ref[i, :v])
