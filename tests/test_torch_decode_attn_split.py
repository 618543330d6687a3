"""The decomposition of the decode-attention kernels (csrc/decode_attn.cu rows 9
and 10) on the CPU: ``split_attention_mirror`` runs the kernels' phases in
plain PyTorch (chunk scores and maxima, the anchor of each T block, chunk
partials, the combine in block order) and is held to

  * the plain version ``_online_attention`` at 1e-5 of the output's peak: both
    compute the same scores and round every probability against the same
    running max, so only the f32 order of the P.V and l sums differs;
  * the JAX package's Pallas kernels in interpret mode at 2e-2 (the JAX
    kernel test's bound, test_decode_attn_pallas.py:52),

for G in {1, 2, 8} query heads per kv head, T in {256, 1024, 1408} (T blocks
of 256, 1024 and 128 positions), chunks of 64 and 128 positions, and one
ragged batch holding lengths 1, C, C + 1, tb, tb + 1 and T.  A variant that
rounds against the global max instead must miss the 1e-5 bound on a cache
whose chunk maxima rise block by block: the test can tell the two apart.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.ops.pallas.decode_attn import (
    decode_attention_fused_stacked as j_fused,
    decode_attention_int8_stacked as j_attn,
)
from acestep_tpu_torch.ops.cuda import decode_attn as tattn
from acestep_tpu_torch.quant.kv import quantize_kv

MIRROR_REL = 1e-5
ATTN_TOL = 2e-2
D = 128
HKV = 2
CHUNKS = (64, 128)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _lengths(t_max):
    tb = tattn.pick_tb(t_max)
    edges = {1, t_max, tb, tb + 1}
    for c in CHUNKS:
        edges |= {c, c + 1}
    return sorted(n for n in edges if n <= t_max)


def _case(g, t_max, seed):
    rng = np.random.default_rng(seed)
    lengths = _lengths(t_max)
    b = len(lengths)
    q = jnp.asarray(rng.standard_normal((b, HKV * g, D)), jnp.bfloat16)
    k_new, v_new = (jnp.asarray(rng.standard_normal((b, HKV, D)), jnp.bfloat16)
                    for _ in range(2))
    # the port's quantize_kv is bit-exact with the JAX package's (test_torch_kv_cache.py)
    cache = [jnp.asarray(a.numpy()) for _ in range(2) for a in quantize_kv(
        torch.from_numpy(rng.standard_normal((1, b, HKV, t_max, D)).astype(np.float32)))]
    qn, kn = (jnp.asarray(rng.standard_normal((D,)), jnp.float32) for _ in range(2))
    pos = np.asarray(lengths, np.float32)
    inv = 1.0 / (1e6 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.concatenate([pos[:, None] * inv[None], pos[:, None] * inv[None]], -1)
    cos, sin = jnp.asarray(np.cos(emb)), jnp.asarray(np.sin(emb))
    return dict(q=q, k=k_new, v=v_new, qn=qn, kn=kn, cos=cos, sin=sin,
                cache=tuple(cache), lens=jnp.asarray(lengths, jnp.int32))


def _mirror_inputs(c, fused):
    """(qb, cache slices of layer 0, lengths, k_self, v_self, tb) as the plain
    versions build them for _online_attention."""
    q, k, v, qn, kn, cos, sin = (_t(c[n]) for n in ("q", "k", "v", "qn", "kn", "cos", "sin"))
    kq, ks, vq, vs = (_t(a)[0] for a in c["cache"])
    b, hq, _ = q.shape
    if fused:
        q = tattn.rms_norm_rope(q, qn, cos, sin, 1e-6)
        k = tattn.rms_norm_rope(k, kn, cos, sin, 1e-6)
    qb = q.float().reshape(b, HKV, hq // HKV, D)
    return (qb, kq, ks, vq, vs, _t(c["lens"]), k.float(), v.float(),
            tattn.pick_tb(kq.shape[2]))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("fused", [False, True], ids=["attn", "fused"])
@pytest.mark.parametrize("t_max", [256, 1024, 1408])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_split_mirror_matches_plain_and_pallas(g, t_max, fused):
    c = _case(g, t_max, 100 * g + t_max + fused)
    args = (c["q"], *c["cache"], c["lens"], jnp.int32(0))
    if fused:
        ref = j_fused(c["q"], c["k"], c["v"], c["qn"], c["kn"], c["cos"], c["sin"],
                      *c["cache"], c["lens"], jnp.int32(0), interpret=True)[0]
    else:
        ref = j_attn(*args, c["k"], c["v"], interpret=True)
    ref = np.asarray(ref)
    inputs = _mirror_inputs(c, fused)
    online = tattn._online_attention(*inputs)
    for chunk in CHUNKS:
        got = tattn.split_attention_mirror(*inputs, chunk)
        assert got.shape == online.shape and got.dtype == torch.float32
        assert _rel(got, online) <= MIRROR_REL, chunk
        np.testing.assert_allclose(got.numpy(), ref, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_global_anchor_misses_the_bound():
    """A cache whose scores rise by ~0.1 a T block: the blocks' running maxima
    lie below the global max, so rounding p * v_scale against the global max
    parts from the sequential kernel by far more than the f32 sum order."""
    rng = np.random.default_rng(7)
    b, g, t_max = 1, 2, 1408
    tb = tattn.pick_tb(t_max)
    q = rng.standard_normal((b, HKV * g, D)).astype(np.float32)
    qdir = q.reshape(b, HKV, g, D).sum(2)
    qdir /= np.linalg.norm(qdir, axis=-1, keepdims=True)
    rise = 0.1 * (np.arange(t_max) // tb) * np.sqrt(D / g)
    k = rng.standard_normal((b, HKV, t_max, D)) + rise[None, None, :, None] * qdir[:, :, None]
    kq, ks = quantize_kv(torch.from_numpy(k.astype(np.float32)))
    vq, vs = quantize_kv(torch.from_numpy(rng.standard_normal((b, HKV, t_max, D))
                                          .astype(np.float32)))
    qb = torch.from_numpy(q).bfloat16().float().reshape(b, HKV, g, D)
    k_self, v_self = (torch.from_numpy(rng.standard_normal((b, HKV, D)).astype(np.float32))
                      .bfloat16().float() for _ in range(2))
    inputs = (qb, kq, ks, vq, vs, torch.tensor([t_max], dtype=torch.int32), k_self, v_self, tb)
    online = tattn._online_attention(*inputs)
    for chunk in CHUNKS:
        assert _rel(tattn.split_attention_mirror(*inputs, chunk), online) <= MIRROR_REL
        glob = tattn.split_attention_mirror(*inputs, chunk, anchor="global")
        assert _rel(glob, online) > 10 * MIRROR_REL, chunk


def test_mirror_rejects_unknown_anchor():
    inputs = _mirror_inputs(_case(1, 256, 0), False)
    with pytest.raises(ValueError, match="anchor"):
        tattn.split_attention_mirror(*inputs, 64, anchor="chunk")
