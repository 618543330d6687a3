"""The VAE res-unit kernels' arithmetic and tile plan, mirrored in plain PyTorch
on the CPU (csrc/vae_resunit.cu runs only on the card).

``mirror_unit`` / ``mirror_trio`` do what the kernels do: the input rows of each
tile of ``tile_rows(C)`` output rows, with the conv's halo of 3d rows a side, zero
outside [0, L); snake1; conv1 as seven shifted products of the tile rows with
the taps, conv2 as one, each operand split into TF32 hi and lo by
round-to-nearest on the f32 bit pattern, hi*lo + lo*hi + hi*hi of each
(tap, 32-channel) chunk summed from zero and added to the total in f32; the
rows of each tile below L written; the trio as three such passes
through a full intermediate tensor.  The weights are read back from the
wrapper's stage images by the kernel's own addressing (the B descriptor's
128-byte swizzle, the A fragment's permuted slots), so the images are tested
too.

Held at 1e-4 (the kernels' f32 bound, tests/test_torch_kernels_plain.py)
against the plain versions and against the JAX Pallas kernels in interpret
mode, at the kernels' channel counts and chip_smoke.py's weight scale (conv1
1/sqrt(7C), conv2 1/sqrt(C)); single-pass TF32 on the same inputs misses the
bound, so the check can tell the two apart.  The mirror rounds every f32 sum
to nearest; the tensor cores truncate within each wgmma, which the per-chunk
sums contain: that error is measured on the card (tests/test_torch_cuda_kernels.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu.ops.pallas import vae_resunit as jvru
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru

TOL = 1e-4


def _unit_params(c, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"snake1": {"alpha": a(c), "beta": a(c)},
            "conv1": {"w": a(7, c, c, s=1.0 / math.sqrt(7 * c)), "b": a(c, s=0.05)},
            "snake2": {"alpha": a(c), "beta": a(c)},
            "conv2": {"w": a(1, c, c, s=1.0 / math.sqrt(c)), "b": a(c, s=0.05)}}


def _to_torch(p):
    return {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in p.items()}


def _to_jax(p):
    return {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in p.items()}


def _x(n, length, c, seed):
    return np.random.default_rng(seed).standard_normal((n, length, c)).astype(np.float32) * 0.5


def weights_from_images(img: torch.Tensor):
    """Stage images [U, 16 C/32, C, 32] -> (hi, lo) [U, 8 taps, ci, co], each
    value read where the kernel reads it: a stage is C rows of 128 bytes (row
    co), slot p of a 32-ci chunk at 16-byte chunk (p // 4) ^ (co % 8), float
    p % 4; slot 8s + u holds ci 8s + 2u, slot 8s + 4 + u ci 8s + 2u + 1."""
    u, _, c, _ = img.shape
    kc = c // 32
    co = torch.arange(c)[:, None]
    p = torch.arange(32)[None, :]
    where = co * 32 + (((p // 4) ^ (co % 8)) * 4) + p % 4              # float in a stage
    v = img.reshape(u, tvru.TAPS, kc, 2, c * 32)[..., where]            # [U, 8, kc, 2, co, p]
    slot = torch.arange(32)
    u8 = slot % 8
    ci_of_slot = 8 * (slot // 8) + torch.where(u8 < 4, 2 * u8, 2 * (u8 - 4) + 1)
    w = torch.empty(u, tvru.TAPS, 2, c, c)
    for k in range(kc):
        w[:, :, :, k * 32 + ci_of_slot, :] = v[:, :, k].permute(0, 1, 2, 4, 3)
    return w[:, :, 0], w[:, :, 1]


def _conv(taps, hi, lo, compensated):
    """The tensor cores' sum over taps x 32-channel chunks, in the kernel's
    order: each tap's A rows [.., C] split in registers; each chunk's products
    (hi*lo, lo*hi, hi*hi) summed from zero and added to the total in f32."""
    tot = 0.0
    for a, w_hi, w_lo in zip(taps, hi, lo):
        ah, al = tvru.tf32_split(a)
        for k in range(0, a.shape[-1], 32):
            s = slice(k, k + 32)
            part = ah[..., s] @ w_hi[s]
            if compensated:
                part = ah[..., s] @ w_lo[s] + al[..., s] @ w_hi[s] + part
            tot = tot + part
    return tot


def _snake(v, a, ib):
    """The kernel's snake: v + ib * sin(a v)^2 with ib = 1 / (beta + 1e-9)."""
    return v + ib * torch.square(torch.sin(a * v))


def mirror_unit(x, hi, lo, vec, dilation, compensated=True):
    """One unit as the kernel computes it.  hi / lo [8, C, C] (taps, ci, co)
    from the stage images; vec [6, C] (b1, b2, a1, ib1, a2, ib2: kernel_vectors)."""
    n, length, c = x.shape
    tm, d = tvru.tile_rows(c), dilation
    tiles = -(-length // tm)
    b1, b2, a1, ib1, a2, ib2 = vec
    pos = (torch.arange(tiles) * tm)[:, None] + torch.arange(tm + 6 * d)[None, :] - 3 * d
    valid = ((pos >= 0) & (pos < length))[None, :, :, None]
    rows = x[:, pos.clamp(0, length - 1)] * valid                      # [N, tiles, rows, C]
    t = torch.where(valid, _snake(rows, a1, ib1), torch.zeros(()))
    acc = _conv([t[:, :, j * d:j * d + tm] for j in range(7)], hi[:7], lo[:7], compensated)
    y = _snake(acc + b1, a2, ib2)
    out = rows[:, :, 3 * d:3 * d + tm] + (_conv([y], hi[7:], lo[7:], compensated) + b2)
    return out.reshape(n, tiles * tm, c)[:, :length]


def mirror_trio(x, hi, lo, vec, compensated=True):
    """The trio: three unit passes, the intermediates through full tensors."""
    for i, d in enumerate(tvru.TRIO_D):
        x = mirror_unit(x, hi[i], lo[i], vec[i], d, compensated)
    return x


def _kernel_operands(tensors):
    """stage images and vectors of stacked unit_tensors, as the CUDA path makes them"""
    w1, b1, w2, b2, a1, be1, a2, be2 = tensors
    hi, lo = weights_from_images(tvru.stage_images(w1, w2))
    return hi, lo, tvru.kernel_vectors(b1, b2, a1, be1, a2, be2)


def _unit_case(c, d, n, length, seed):
    p = _unit_params(c, seed)
    tens = tvru.unit_tensors(_to_torch(p))
    hi, lo, vec = _kernel_operands(tuple(t[None] for t in tens))
    x = torch.from_numpy(_x(n, length, c, seed + 1))
    return p, tens, (hi[0], lo[0], vec[0]), x


def _trio_case(n, length, seed):
    units = tuple(_unit_params(128, seed + i) for i in range(3))
    st = tvru.trio_operands(tuple(_to_torch(u) for u in units)).plain
    x = torch.from_numpy(_x(n, length, 128, seed + 5))
    return units, st, _kernel_operands(st), x


def _err_over_tol(got, ref) -> float:
    return float(((got - ref).abs() / (TOL + TOL * ref.abs())).max())


@pytest.mark.parametrize("c", [128, 256])
def test_stage_images_hold_the_split_weights(c):
    rng = np.random.default_rng(c)
    w1 = torch.from_numpy(rng.standard_normal((2, 7, c, c)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((2, c, c)).astype(np.float32))
    img = tvru.stage_images(w1, w2)
    assert img.shape == (2, 16 * c // 32, c, 32) and img.dtype == torch.float32
    hi, lo = weights_from_images(img)
    w = torch.cat([w1, w2[:, None]], 1)
    ref_hi, ref_lo = tvru.tf32_split(w)
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)
    # hi and lo are TF32 values; together they keep ~22 significant bits
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert float(((hi + lo - w).abs() / w.abs().clamp_min(1e-30)).max()) < 2.0 ** -21


def test_tf32_round_is_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's step at 1.0
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23,
                      one + 1.5 * ulp, 3.0], dtype=torch.float32)
    got = tvru.tf32_round(x)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("n,length", [(1, 1100), (2, 77), (1, 20)])
def test_mirror_unit_vs_plain(c, d, n, length):
    _, tens, (hi, lo, vec), x = _unit_case(c, d, n, length, 10 * d + c)
    got = mirror_unit(x, hi, lo, vec, d)
    ref = tvru.res_unit_plain(x, *tens, d)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,length", [(1, 1100), (2, 77), (1, 20)])
def test_mirror_trio_vs_plain(n, length):
    _, st, (hi, lo, vec), x = _trio_case(n, length, 40 + length)
    got = mirror_trio(x, hi, lo, vec)
    torch.testing.assert_close(got, tvru.res_trio_plain(x, *st), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [1, 9])
def test_mirror_unit_vs_pallas(d):
    p, _, (hi, lo, vec), x = _unit_case(256, d, 1, 1100, 70 + d)
    ref = np.asarray(jvru.fused_res_unit(_to_jax(p), jnp.asarray(x.numpy()), d,
                                         interpret=True))
    np.testing.assert_allclose(mirror_unit(x, hi, lo, vec, d).numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n,length", [(1, 1100), (2, 77)])
def test_mirror_trio_vs_pallas(n, length):
    units, _, (hi, lo, vec), x = _trio_case(n, length, 80 + length)
    ref = np.asarray(jvru.fused_res_trio(tuple(_to_jax(u) for u in units),
                                         jnp.asarray(x.numpy()), interpret=True))
    got = mirror_trio(x, hi, lo, vec)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_single_pass_tf32_misses_the_bound():
    """The planted fault the card checks reject: without the lo products the
    same inputs land well outside 1e-4 (unit at C = 256, trio at C = 128)."""
    _, tens, (hi, lo, vec), x = _unit_case(256, 9, 1, 1100, 90)
    ref = tvru.res_unit_plain(x, *tens, 9)
    assert _err_over_tol(mirror_unit(x, hi, lo, vec, 9), ref) < 0.5
    assert _err_over_tol(mirror_unit(x, hi, lo, vec, 9, compensated=False), ref) > 3.0
    _, st, (hi, lo, vec), x = _trio_case(1, 1100, 95)
    ref = tvru.res_trio_plain(x, *st)
    assert _err_over_tol(mirror_trio(x, hi, lo, vec), ref) < 0.5
    assert _err_over_tol(mirror_trio(x, hi, lo, vec, compensated=False), ref) > 3.0


def test_operands_prepared_once_per_param_dict():
    p = _to_torch(_unit_params(128, 1))
    ops = tvru.unit_operands(p)
    assert tvru.unit_operands(p) is ops                 # kept while the tensors live
    assert ops.stages is None and ops.vec is None       # the CPU takes the plain version
    torch.testing.assert_close(ops.plain[4], torch.exp(p["snake1"]["alpha"]))
    units = tuple(_to_torch(_unit_params(128, 2 + i)) for i in range(3))
    trio = tvru.trio_operands(units)
    assert tvru.trio_operands(units) is trio and trio.plain[0].shape == (3, 7, 128, 128)
    q = _to_torch(_unit_params(128, 1))                 # equal values, other tensors
    assert tvru.unit_operands(q) is not ops
    n = len(tvru._PREPARED)
    del p, ops, q
    assert len(tvru._PREPARED) <= n - 2                 # an entry goes with its tensors
