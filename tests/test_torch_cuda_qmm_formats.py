"""The port's q4_0, q4_k and q6_k dequant-matmul kernels against their plain
PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one (CUDA kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs on the
card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_qmm_formats.py -q

Tolerance, that of the JAX package's Pallas kernel test (test_qmm_pallas.py:
largest difference below 2% of the mean |output|, at least 98% of the outputs
equal).  The kernel and the plain version differ only in the f32 summation
order; rounded to bf16, that flips an output by one bf16 step now and then, and
one step at the largest of a million outputs (~6x the mean) is ~3.5% of the
mean |output|.  So the 2% bound holds the f32 outputs (the same kernel with
the last rounding left out), and the 98% bound the bf16 outputs, where a flip
is at most one step (2^-7 of the value).
"""

import pytest
import torch

from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize, stack_layers

FORMATS = ("q4_0", "q4_k", "q6_k")
REL_MAX = 0.02
EQUAL_MIN = 0.98

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qt(fmt, k, n, seed, dev, layers=None):
    g = torch.Generator(device=dev).manual_seed(seed)

    def one():
        return precast_quant_scales(quantize(torch.randn((k, n), generator=g, device=dev)
                                             * 0.05, fmt))

    return one() if layers is None else stack_layers([one() for _ in range(layers)])


def _assert_close(x, qt, bias=None, li=None):
    """The kernel against the plain version on ``x @ qt (+ bias)``, at f32 and
    at bf16 output (layer ``li`` of a stacked weight)."""
    w = qt if li is None else qt.layer(li)
    for dtype in (torch.float32, torch.bfloat16):
        got = (tqmm.qmm(x, w, bias, dtype) if li is None
               else tqmm.qmm_stacked(x, qt, li, bias, dtype)).float()
        ref = tqmm.qmm_plain(x, w, bias, dtype).float()
        assert torch.isfinite(got).all()
        err = (got - ref).abs()
        if dtype == torch.float32:
            assert float(err.max() / ref.abs().mean()) < REL_MAX
        else:
            assert float((got == ref).float().mean()) > EQUAL_MIN
            # one bf16 step; the floor covers outputs that cancel to near zero
            assert bool((err <= 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().mean()).all())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,k,n", [(1, 256, 2048), (77, 2048, 200), (768, 2048, 4096),
                                   (64, 1024, 3072), (768, 6144, 2048), (5, 512, 40)])
def test_kernel_vs_plain(dev, fmt, m, k, n):
    qt = _qt(fmt, k, n, m + n, dev)
    x = torch.randn((m, k), device=dev).bfloat16()
    kern = tqmm.KERNELS[fmt]
    before = kern.launches
    for bias in (None, torch.randn(n, device=dev)):
        _assert_close(x, qt, bias)
    assert kern.launches == before + 4


@pytest.mark.parametrize("fmt", FORMATS)
def test_stacked_kernel_vs_plain(dev, fmt):
    st = _qt(fmt, 2048, 1024, 3, dev, layers=3)
    x = torch.randn((128, 2048), device=dev).bfloat16()
    before = tqmm.KERNELS[fmt].launches
    for li in range(3):
        _assert_close(x, st, li=li)
    assert tqmm.KERNELS[fmt].launches == before + 6


@pytest.mark.parametrize("fmt", FORMATS)
def test_rejects_what_the_kernel_does_not_take(dev, fmt):
    qt = _qt(fmt, 512, 64, 0, dev)
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((4, 256), device=dev).bfloat16(), qt)       # K mismatch
    raw = quantize(torch.randn((512, 64), device=dev), fmt)              # f16 scales
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((4, 512), device=dev).bfloat16(), raw)
