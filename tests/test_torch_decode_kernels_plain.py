"""Port parity: the plain PyTorch versions of the decode kernels
(ops/cuda/decode_attn.py rows 9 and 10, ops/cuda/decode_mega.py row 11) against
the JAX package's Pallas kernels run in interpret mode on the CPU, at the JAX
kernel tests' shapes, on the same numpy-seeded inputs.

Tolerances are the JAX tests' own: decode attention 2e-2 (test_decode_attn_
pallas.py:52), the fused kernel's output 3e-2 with K/V scales to rtol 2e-2 and
int8 values within 2 (:194-208); the megakernel (test_decode_mega.py:64-70)
relative error below 2e-2 of the peak on its output rows, int8 K/V within 2.
The row 11 comparison also holds the argmax of each output row, as the JAX test
holds the argmax of the logits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.config import QwenConfig
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.ops.pallas.decode_attn import (
    decode_attention_fused_stacked as j_fused,
    decode_attention_int8_stacked as j_attn,
)
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu.serving import kv_cache as jkvc
from acestep_tpu.serving import lm as jlm
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import weights
from acestep_tpu_torch.ops.cuda import decode_attn as tattn
from acestep_tpu_torch.ops.cuda import decode_mega as tmega
from acestep_tpu_torch.serving import lm as tlm

ATTN_TOL = 2e-2
FUSED_TOL = 3e-2
MEGA_REL = 2e-2
INT8_MAX_DIFF = 2


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _cache(rng, n_l, b, hkv, t_max, d):
    k = jnp.asarray(rng.standard_normal((n_l, b, hkv, t_max, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((n_l, b, hkv, t_max, d)), jnp.float32)
    kq, ks = jkvc.quantize_kv(k)
    vq, vs = jkvc.quantize_kv(v)
    return kq, ks, vq, vs


ATTN_CASES = [   # (b, hq, hkv, t_max, n_l, lengths)
    (1, 8, 4, 256, 3, [1]), (1, 8, 4, 256, 3, [7]), (1, 8, 4, 256, 3, [128]),
    (1, 8, 4, 256, 3, [200]), (4, 8, 4, 256, 3, [1, 100, 128, 256]),
    (2, 16, 4, 512, 2, [300, 511]),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"b{c[0]}-g{c[1] // c[2]}-{c[5]}")
def test_decode_attention_plain_matches_pallas(case):
    b, hq, hkv, t_max, n_l, lengths = case
    d = 128
    rng = np.random.default_rng(sum(lengths) + hq)
    q = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.bfloat16)
    kq, ks, vq, vs = _cache(rng, n_l, b, hkv, t_max, d)
    k_self = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.bfloat16)
    v_self = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.bfloat16)
    lens = jnp.asarray(lengths, jnp.int32)
    targs = [_t(a) for a in (q, kq, ks, vq, vs, lens)]
    for li in (0, n_l - 1):                        # the first and the last layer
        ref = j_attn(q, kq, ks, vq, vs, lens, jnp.int32(li), k_self, v_self, interpret=True)
        got = tattn.decode_attention_int8_stacked(*targs, li, _t(k_self), _t(v_self))
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, hq, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("b,lengths", [(1, [1]), (1, [200]), (3, [1, 100, 256])])
def test_fused_attention_plain_matches_pallas(b, lengths):
    hq, hkv, d, t_max, n_l = 8, 4, 128, 256, 2
    rng = np.random.default_rng(11 + b)
    q_raw = jnp.asarray(rng.standard_normal((b, hq, d)), jnp.bfloat16)
    k_raw = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.bfloat16)
    v_raw = jnp.asarray(rng.standard_normal((b, hkv, d)), jnp.bfloat16)
    qn = jnp.asarray(rng.standard_normal((d,)), jnp.float32)
    kn = jnp.asarray(rng.standard_normal((d,)), jnp.float32)
    pos = np.asarray(lengths, np.float32)
    inv = 1.0 / (1e6 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    emb = np.concatenate([pos[:, None] * inv[None], pos[:, None] * inv[None]], -1)
    cos, sin = jnp.asarray(np.cos(emb)), jnp.asarray(np.sin(emb))
    kq, ks, vq, vs = _cache(rng, n_l, b, hkv, t_max, d)
    lens = jnp.asarray(lengths, jnp.int32)
    for li in range(n_l):
        ref = j_fused(q_raw, k_raw, v_raw, qn, kn, cos, sin, kq, ks, vq, vs, lens,
                      jnp.int32(li), interpret=True)
        got = tattn.decode_attention_fused_stacked(
            *(_t(a) for a in (q_raw, k_raw, v_raw, qn, kn, cos, sin, kq, ks, vq, vs, lens)),
            li)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=FUSED_TOL,
                                   atol=FUSED_TOL)
        for i in (1, 3):
            d8 = np.abs(got[i].numpy().astype(np.int32) - np.asarray(ref[i], np.int32))
            assert d8.max() <= INT8_MAX_DIFF
        for i in (2, 4):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=2e-2,
                                       atol=1e-4)


def test_unsupported_shapes_return_none():
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16)
    kc = torch.zeros((1, 1, 4, 96, 128), dtype=torch.int8)     # T = 96
    sc = torch.zeros((1, 1, 4, 96))
    lens = torch.tensor([5], dtype=torch.int32)
    assert tattn.decode_attention_int8_stacked(q, kc, sc, kc, sc, lens, 0, q[:, :4],
                                               q[:, :4]) is None
    assert not tattn.takes(8, 4, 64, 256) and not tattn.takes(32, 2, 128, 256)
    assert tattn.takes(16, 8, 128, 1408) and tattn.pick_tb(1408) == 128


# ---------------------------------------------------------------------------
# row 11: the megakernel at test_decode_mega.py's config
# ---------------------------------------------------------------------------

MEGA_CFG = QwenConfig(hidden_size=1024, num_hidden_layers=2, num_attention_heads=16,
                      num_key_value_heads=8, intermediate_size=3072, vocab_size=2048)
MEGA_T = 512


@pytest.fixture(scope="module")
def mega_params():
    rng = np.random.default_rng(0)
    p = jqwen.init_params(jax.random.key(0), MEGA_CFG, dtype=jnp.bfloat16, scale=1.0,
                          sampler=lambda s: (rng.standard_normal(s) * 0.02).astype(np.float32))
    jp = jlm.fuse_serving_params(jlm.ensure_quantized_head(
        jqwen.stack_params(quantize_tree_jax(p, "q8_0"))))
    return jp, weights.from_jax_numpy(jp)


def _mega_inputs(b, seed):
    rng = np.random.default_rng(seed)
    n_l, hkv, d = MEGA_CFG.num_hidden_layers, MEGA_CFG.num_key_value_heads, MEGA_CFG.head_dim
    kq, ks, vq, vs = _cache(rng, n_l, b, hkv, MEGA_T, d)
    lengths = rng.integers(1, MEGA_T - 1, (b,)).astype(np.int32)
    lengths[0] = 37
    x0 = jnp.asarray(rng.standard_normal((b, MEGA_CFG.hidden_size)) * 0.02, jnp.bfloat16)
    cos, sin = jlm._rope_at(jnp.asarray(lengths), d, MEGA_CFG.rope_theta)
    return kq, ks, vq, vs, jnp.asarray(lengths), x0, cos[:, 0], sin[:, 0]


@pytest.mark.parametrize("b", [1, 4])
def test_mega_plain_matches_pallas(mega_params, b):
    from jax.experimental.pallas import tpu as pltpu

    from acestep_tpu.ops.pallas.decode_mega import decode_layers_mega

    jp, tp = mega_params
    args = _mega_inputs(b, b)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda *a: decode_layers_mega(jp["layers"], MEGA_CFG, *a))(*args)
    cfg = tcfg.QwenConfig(**{f: getattr(MEGA_CFG, f) for f in MEGA_CFG.__dataclass_fields__})
    assert tmega.supported(tp["layers"], cfg, b, MEGA_T)
    got = tmega.decode_layers_mega(tp["layers"], cfg, *(_t(a) for a in args))
    x_ref, x_got = np.asarray(ref[0]), got[0].numpy()
    assert np.abs(x_got - x_ref).max() < MEGA_REL * np.abs(x_ref).max()
    np.testing.assert_array_equal(x_got.argmax(-1), x_ref.argmax(-1))
    for i in (1, 3):
        d8 = np.abs(got[i].numpy().astype(np.int32) - np.asarray(ref[i], np.int32))
        assert d8.max() <= INT8_MAX_DIFF
    for i in (2, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), rtol=2e-2, atol=1e-6)


def test_mega_gate(mega_params):
    _, tp = mega_params
    cfg = tcfg.QwenConfig(**{f: getattr(MEGA_CFG, f) for f in MEGA_CFG.__dataclass_fields__})
    layers = tp["layers"]
    assert tmega.supported(layers, cfg, 1, 512) and tmega.supported(layers, cfg, 8, 2048)
    assert not tmega.supported(layers, cfg, 16, 512)         # B cap
    assert not tmega.supported(layers, cfg, 1, 500)          # T granularity
    bad = tcfg.QwenConfig(hidden_size=512, num_hidden_layers=2, num_attention_heads=16,
                          num_key_value_heads=8, intermediate_size=3072)
    assert not tmega.supported(layers, bad, 1, 512)
    unfused = {k: v for k, v in layers.items() if k != "qkv_proj"}
    assert not tmega.supported(unfused, cfg, 1, 512)
    # the card kernel's own limit: one launch's device scratch, monotone in T
    huge_t = 512 * 1024
    assert 4 * tmega.scratch_floats(8, 1024, 16, 8, 3072, huge_t) > tmega.MAX_SCRATCH
    ts = [1024, 4096, 16384, 65536, huge_t]
    oks = [tmega.supported(layers, cfg, 8, t) for t in ts]
    assert oks == sorted(oks, reverse=True) and oks[0] and not oks[-1]


def test_mega_decode_step_matches_scan(mega_params):
    """decode_step through the megakernel's plain version (decode_mega="1")
    against the layer scan, at the JAX test's logits bound; the cache rows the
    step writes are exactly the megakernel's new K/V at each length, and no
    other row changes.  (The int8 rows of the two paths themselves differ by up
    to 3 on these weights in the JAX package as well: the scan rounds k to
    bf16 before quantizing, the megakernel does not.)"""
    from acestep_tpu_torch.serving import kv_cache as tkvc

    _, tp = mega_params
    cfg = tcfg.QwenConfig(**{f: getattr(MEGA_CFG, f) for f in MEGA_CFG.__dataclass_fields__})
    b = 4
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, 2000, (b, 37)))
    cache = tkvc.init_cache(2, b, 8, MEGA_T, 128)
    _, cache = tlm.prefill(tp, cfg, prompt, torch.full((b,), 37, dtype=torch.int32), cache)
    tok = torch.from_numpy(rng.integers(1, 2000, (b,)))
    ref, _ = tlm.decode_step(tp, cfg, cache.clone(), tok, decode_mega="0")
    got, got_c = tlm.decode_step(tp, cfg, cache.clone(), tok, decode_mega="1")
    assert float((got - ref).abs().max() / ref.abs().max()) < MEGA_REL
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    cos, sin = tlm._rope_at(cache.length, 128, cfg.rope_theta)
    _, k_new, ks_new, v_new, vs_new = tmega.decode_layers_mega(
        tp["layers"], cfg, cache.k, cache.k_scale, cache.v, cache.v_scale, cache.length,
        tp["embed_tokens"][tok], cos[:, 0], sin[:, 0])
    for name, new in (("k", k_new), ("v", v_new), ("k_scale", ks_new), ("v_scale", vs_new)):
        after, before = getattr(got_c, name), getattr(cache, name)
        assert torch.equal(after[:, :, :, 37], new), name
        keep = torch.ones(MEGA_T, dtype=torch.bool)
        keep[37] = False
        assert torch.equal(after[:, :, :, keep], before[:, :, :, keep]), name
