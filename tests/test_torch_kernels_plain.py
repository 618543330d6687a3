"""Port parity: the plain PyTorch versions of the port's CUDA kernels (what the
wrappers run for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the CPU.

Tolerances: q8_0 dequant-matmul atol 1e-2 (tests/test_qmm_pallas.py:44) with
rtol 1e-2, because both outputs are rounded to bf16 (one bf16 step is 2^-7 of
the value, 0.016 at |y| = 2, so a sum taken in another order can land one step
apart); VAE res unit / trio 1e-4 in f32 (tests/test_vae_resunit_fused.py:39).
The kernel-module tests run at the kernels' real channel counts (C=256 unit,
C=128 trio) with short, tile-ragged lengths.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.ops.pallas import qmm as jqmm
from acestep_tpu.ops.pallas import vae_resunit as jvru
from acestep_tpu.quant import formats as jfmt
from acestep_tpu_torch import weights
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru

QMM_ATOL = 1e-2
QMM_RTOL = 1e-2
RESUNIT_TOL = 1e-4


def _qt(k, n, seed):
    rng = np.random.default_rng(seed)
    return jfmt.quantize_q8_0_np(rng.standard_normal((k, n)).astype(np.float32) * 0.05)


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("m,k,n", [(5, 512, 256), (64, 1024, 128), (130, 512, 384)])
def test_qmm_plain_vs_pallas(m, k, n):
    qt_j = _qt(k, n, m + k + n)
    x = _x(m, k, m)
    ref = np.asarray(jqmm.qmm_pallas(jnp.asarray(x, jnp.bfloat16), qt_j, interpret=True)
                     .astype(jnp.float32))
    got = tqmm.qmm(torch.from_numpy(x), weights.from_jax_numpy(qt_j)).float().numpy()
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, ref, atol=QMM_ATOL, rtol=QMM_RTOL)


def test_qmm_plain_stacked_vs_pallas():
    k, n, layers = 512, 256, 3
    qts = [_qt(k, n, 10 + i) for i in range(layers)]
    st_j = jfmt.QuantTensor(fmt="q8_0", shape=(k, n),
                            data=jnp.stack([q.data for q in qts]),
                            scales=jnp.stack([q.scales for q in qts]))
    st = weights.from_jax_numpy(st_j)
    x = _x(128, k, 3)
    for li in range(layers):
        ref = np.asarray(jqmm.qmm_pallas_stacked(
            jnp.asarray(x, jnp.bfloat16), st_j, jnp.int32(li), interpret=True
        ).astype(jnp.float32))
        got = tqmm.qmm_stacked(torch.from_numpy(x), st, li).float().numpy()
        np.testing.assert_allclose(got, ref, atol=QMM_ATOL, rtol=QMM_RTOL)


def test_qmm_nd_bias_and_out_dtype():
    """Bias is added in f32 before the single output rounding (the XLA linear
    path's numerics); the output dtype is the caller's."""
    qt_j = _qt(256, 64, 5)
    x = _x(6, 256, 6).reshape(2, 3, 256)
    bias = np.random.default_rng(7).standard_normal(64).astype(np.float32)
    wd = np.asarray(jfmt.dequantize(qt_j, jnp.bfloat16).astype(jnp.float32))
    ref = _bf16_np(x) @ wd + bias
    got = tqmm.qmm_nd(torch.from_numpy(x), weights.from_jax_numpy(qt_j),
                      torch.from_numpy(bias), out_dtype=torch.float32)
    assert got.shape == (2, 3, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_unsupported_device():
    qt = weights.from_jax_numpy(_qt(64, 8, 1))
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros(2, 64, device="meta"), qt)
    with pytest.raises(ValueError):
        tvru.launch_trio(torch.zeros(1, 8, 128, device="meta"), ())


def _unit_params(c, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, s=0.3):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"snake1": {"alpha": a(c), "beta": a(c)},
            "conv1": {"w": a(7, c, c, s=0.05), "b": a(c, s=0.1)},
            "snake2": {"alpha": a(c), "beta": a(c)},
            "conv2": {"w": a(1, c, c, s=0.05), "b": a(c, s=0.1)}}


def _to_jax(p):
    return {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in p.items()}


def _to_torch(p):
    return {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in p.items()}


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_res_unit_plain_vs_pallas(dilation):
    c, length = 256, 1100                      # kernel tile 1024: one full + ragged tail
    p = _unit_params(c, dilation)
    x = np.random.default_rng(1).standard_normal((1, length, c)).astype(np.float32) * 0.5
    ref = np.asarray(jvru.fused_res_unit(_to_jax(p), jnp.asarray(x), dilation,
                                         interpret=True))
    got = tvru.fused_res_unit(_to_torch(p), torch.from_numpy(x), dilation).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=RESUNIT_TOL, rtol=RESUNIT_TOL)


@pytest.mark.parametrize("length", [1100, 77])   # ragged tiles; shorter than the halo reach
def test_res_trio_plain_vs_pallas(length):
    c = 128
    units = [_unit_params(c, 20 + i) for i in range(3)]
    x = np.random.default_rng(2).standard_normal((2, length, c)).astype(np.float32) * 0.5
    ref = np.asarray(jvru.fused_res_trio(tuple(_to_jax(u) for u in units), jnp.asarray(x),
                                         interpret=True))
    got = tvru.fused_res_trio(tuple(_to_torch(u) for u in units), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=RESUNIT_TOL, rtol=RESUNIT_TOL)
