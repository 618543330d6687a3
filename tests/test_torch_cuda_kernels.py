"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (CUDA kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs on the
card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: q8_0 dequant-matmul atol 1e-2 with rtol 1e-2 (bf16 outputs, K up
to 6144: one bf16 step is 2^-7 of the value); res unit / trio 1e-4 in f32.
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru
from acestep_tpu_torch.quant import QuantTensor, quantize_q8_0

QMM_ATOL = 1e-2
QMM_RTOL = 1e-2
RESUNIT_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qt(k, n, seed, dev, layers=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    if layers is None:
        qt = quantize_q8_0(torch.randn((k, n), generator=g, device=dev) * 0.05)
        return QuantTensor("q8_0", (k, n), qt.data, qt.scales.float())
    qts = [quantize_q8_0(torch.randn((k, n), generator=g, device=dev) * 0.05)
           for _ in range(layers)]
    return QuantTensor("q8_0", (k, n), torch.stack([q.data for q in qts]),
                       torch.stack([q.scales.float() for q in qts]))


@pytest.mark.parametrize("m,k,n", [(1, 256, 2048), (77, 2048, 200), (128, 6144, 2048),
                                   (320, 2048, 1024), (65, 96, 64)])
def test_qmm_kernel_vs_plain(dev, m, k, n):
    qt = _qt(k, n, m + n, dev)
    x = torch.randn((m, k), device=dev).bfloat16()
    bias = torch.randn(n, device=dev)
    for b in (None, bias):
        got = tqmm.qmm(x, qt, b).float()
        ref = tqmm.qmm_plain(x, qt, b).float()
        torch.testing.assert_close(got, ref, atol=QMM_ATOL, rtol=QMM_RTOL)
    got32 = tqmm.qmm(x, qt, bias, out_dtype=torch.float32)
    torch.testing.assert_close(got32, tqmm.qmm_plain(x, qt, bias, torch.float32),
                               atol=QMM_ATOL, rtol=QMM_RTOL)


def test_qmm_stacked_kernel_vs_plain(dev):
    st = _qt(2048, 4096, 3, dev, layers=3)
    x = torch.randn((128, 2048), device=dev).bfloat16()
    before = tqmm.KERNELS["q8_0"].launches
    for li in range(3):
        got = tqmm.qmm_stacked(x, st, li).float()
        torch.testing.assert_close(got, tqmm.qmm_plain(x, st.layer(li)).float(),
                                   atol=QMM_ATOL, rtol=QMM_RTOL)
    assert tqmm.KERNELS["q8_0"].launches == before + 3


def _unit(c, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, s=0.3):
        return torch.randn(shape, generator=g, device=dev) * s

    return {"snake1": {"alpha": r(c), "beta": r(c)},
            "conv1": {"w": r(7, c, c, s=0.05), "b": r(c, s=0.1)},
            "snake2": {"alpha": r(c), "beta": r(c)},
            "conv2": {"w": r(1, c, c, s=0.05), "b": r(c, s=0.1)}}


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("n,length", [(1, 1000), (2, 33), (1, 5), (1, 20), (2, 45),
                                      (1, 122880)])
def test_res_unit_kernel_vs_plain(dev, c, n, length):
    """(1, 122880): the 256-channel block of a 512-frame window of the 60 s
    request; 5 / 20 / 33 / 45 rows: shorter than the conv's reach at d = 9."""
    x = torch.randn((n, length, c), device=dev) * 0.5
    for d in (1, 3, 9):
        ops = tvru.unit_operands(_unit(c, d, dev), dev)
        torch.testing.assert_close(tvru.launch_unit(x, ops, d),
                                   tvru.res_unit_plain(x, *ops.plain, d),
                                   atol=RESUNIT_TOL, rtol=RESUNIT_TOL)


@pytest.mark.parametrize("n,length", [(1, 1000), (2, 77), (1, 20), (2, 45), (1, 5),
                                      (2, 70), (1, 491520)])
def test_res_trio_kernel_vs_plain(dev, n, length):
    """(1, 491520): the first 128-channel block of a 512-frame window of the 60 s
    request; 5-77 rows: at or below the chained reach of 39 a side."""
    x = torch.randn((n, length, 128), device=dev) * 0.5
    ops = tvru.trio_operands(tuple(_unit(128, 10 + i, dev) for i in range(3)), dev)
    torch.testing.assert_close(tvru.launch_trio(x, ops), tvru.res_trio_plain(x, *ops.plain),
                               atol=RESUNIT_TOL, rtol=RESUNIT_TOL)


def test_res_kernels_rerun_bit_identical(dev):
    x = torch.randn((2, 3001, 128), device=dev) * 0.5
    ops = tvru.trio_operands(tuple(_unit(128, 20 + i, dev) for i in range(3)), dev)
    assert torch.equal(tvru.launch_trio(x, ops), tvru.launch_trio(x, ops))
    x = torch.randn((1, 4001, 256), device=dev) * 0.5
    ops = tvru.unit_operands(_unit(256, 23, dev), dev)
    assert torch.equal(tvru.launch_unit(x, ops, 9), tvru.launch_unit(x, ops, 9))


def _outside(got, ref) -> bool:
    return bool(((got - ref).abs() > RESUNIT_TOL + RESUNIT_TOL * ref.abs()).any())


def test_res_single_pass_tf32_rejected(dev):
    """The kernels built without the lo products miss the 1e-4 bound at the
    10 s request's shapes, so the bound tells TF32 from f32."""
    x = torch.randn((1, 60000, 256), device=dev) * 0.5
    ops = tvru.unit_operands(_unit(256, 30, dev), dev)
    ref = tvru.res_unit_plain(x, *ops.plain, 9)
    assert not _outside(tvru.launch_unit(x, ops, 9), ref)
    assert _outside(tvru.launch_unit_tf32(x, ops, 9), ref)
    x = torch.randn((1, 240000, 128), device=dev) * 0.5
    ops = tvru.trio_operands(tuple(_unit(128, 31 + i, dev) for i in range(3)), dev)
    ref = tvru.res_trio_plain(x, *ops.plain)
    assert not _outside(tvru.launch_trio(x, ops), ref)
    assert _outside(tvru.launch_trio_tf32(x, ops), ref)
