"""The port's dequant-matmul kernel for every quant format (csrc/qmm_wgmma.cu:
q8_0, q4_0, q4_k, q6_k on one wgmma mainloop, a TMA / cp.async ring, 128-row
tiles, split-K at small M summed in a cluster) against its plain PyTorch
version, on the card.

Every test here needs an NVIDIA GPU and skips without one (CUDA kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs on the
card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_qmm_kquant.py -q

Tolerance, that of tests/test_torch_cuda_qmm_formats.py (the JAX package's
Pallas kernel test): the f32 outputs' largest difference below 2% of the mean
|output|, at least 98% of the bf16 outputs equal, each within one bf16 step.
The kernel and the plain version differ only in the f32 summation order.  The
plain wgmma tile sums bf16 products exactly representable in f32, so it is held
to 1e-5 (relative) of torch.matmul in f32.
"""

import pytest
import torch

from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize, stack_layers

FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
REL_MAX = 0.02
EQUAL_MIN = 0.98
# the 60 s decoder's products (M = 768 patches) and configs[2]'s 120 s bucket
# (M = 1536): fused qkv, o_proj / cross q / cross o, fused gate-up, down
DECODER = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]
# the request's small-M products: timestep linears (M 1), text encoder (64),
# lyric encoder (256), cross K/V and condition projection (320)
SMALL = [(1, 256, 2048), (1, 2048, 12288), (64, 1024, 3072), (64, 3072, 1024),
         (256, 2048, 6144), (256, 6144, 2048), (320, 2048, 1024), (320, 2048, 2048)]
SHAPES = ([(768, k, n) for k, n in DECODER] + [(1536, k, n) for k, n in DECODER]
          + [(770, 2048, 4096)] + SMALL + [(77, 2048, 200), (5, 512, 40)]
          # the 10 s decoder (M = 128) and the block heights' edges
          + [(128, 2048, 2048), (128, 6144, 2048), (16, 2048, 2048), (17, 2048, 2048),
             (65, 1024, 1024)])
# q8_0 only: K % 128 != 0 (96, 160 and 320: the last step's second x atom part
# and wholly past K, and its first atom part past K), K = 384 (the 60 s
# proj_in, also at M = 128 and 768)
Q8_ONLY = [(1, 96, 64), (65, 96, 64), (16, 160, 2048), (3, 320, 1000), (128, 384, 2048),
           (768, 384, 2048)]
CASES = [(fmt,) + s for fmt in FORMATS for s in SHAPES] + [("q8_0",) + s for s in Q8_ONLY]

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


def _x(m, k, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((m, k), generator=g, device=dev).bfloat16()


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


def test_wgmma_tile_matches_matmul(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((64, 64), generator=g, device=dev).bfloat16()
    b = torch.randn((128, 64), generator=g, device=dev).bfloat16()
    got = tqmm.wgmma_tile(a, b)
    ref = a.float() @ b.float().t()
    assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("fmt,m,k,n", CASES)
def test_kernel_vs_plain(dev, fmt, m, k, n):
    qt = _qt(fmt, k, n, m + n, dev)
    x = _x(m, k, m + k, dev)
    kern = tqmm.KERNELS[fmt]
    before = kern.launches
    _assert_close(x, qt)
    _assert_close(x, qt, torch.randn(n, device=dev))
    assert kern.launches == before + 4


@pytest.mark.parametrize("fmt", FORMATS)
def test_stacked_layer_in_place(dev, fmt):
    """Layer 2 of a 3-layer stacked weight, read through its base pointers."""
    st = _qt(fmt, 2048, 2048, 3, dev, layers=3)
    x = _x(768, 2048, 4, dev)
    _assert_close(x, st, torch.randn(2048, device=dev), li=2)
    got = tqmm.qmm_stacked(x, st, 2)
    assert torch.equal(got, tqmm.qmm(x, st.layer(2)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("m,k,n", [(768, 2048, 2048), (64, 1024, 3072), (1, 2048, 2048),
                                   (128, 2048, 2048)])
def test_reruns_bit_identical(dev, fmt, m, k, n):
    """Two launches give the same bits (the K splits are summed in order)."""
    qt = _qt(fmt, k, n, 7, dev)
    x = _x(m, k, 8, dev)
    bias = torch.randn(n, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(tqmm.qmm(x, qt, bias, dtype), tqmm.qmm(x, qt, bias, dtype))


def test_q8_0_ragged_k_split_reruns_bit_identical(dev):
    """A q8_0 K split whose last step is partial (K = 320: 3 steps, 3 splits)
    gives the same bits twice and meets the plain version."""
    assert tqmm.wgmma_plan("q8_0", 3, 320, 1000) == (16, 3)
    qt = _qt("q8_0", 320, 1000, 9, dev)
    x = _x(3, 320, 10, dev)
    bias = torch.randn(1000, device=dev)
    _assert_close(x, qt, bias)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(tqmm.qmm(x, qt, bias, dtype), tqmm.qmm(x, qt, bias, dtype))


@pytest.mark.parametrize("fmt", FORMATS)
def test_launch_counter(dev, fmt):
    """One count per launch, by shape, whether or not K is split."""
    kern = tqmm.KERNELS[fmt]
    kern.reset()
    for m, k, n in [(768, 2048, 256), (64, 1024, 256), (64, 1024, 256)]:
        tqmm.qmm(_x(m, k, 1, dev), _qt(fmt, k, n, 2, dev))
    assert kern.launches == 3
    assert kern.shapes == {(768, 2048, 256): 1, (64, 1024, 256): 2}
    assert tqmm.wgmma_plan(fmt, 64, 1024, 256)[1] > 1    # the split path was counted too


@pytest.mark.parametrize("fmt", FORMATS)
def test_rejects_what_the_kernel_does_not_take(dev, fmt):
    qt = _qt(fmt, 512, 64, 0, dev)
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((4, 256), device=dev).bfloat16(), qt)       # K mismatch
    raw = quantize(torch.randn((512, 64), device=dev), fmt)              # f16 scales
    with pytest.raises(ValueError):
        tqmm.qmm(torch.zeros((4, 512), device=dev).bfloat16(), raw)


@pytest.mark.parametrize("fmt", FORMATS)
def test_misaligned_x(dev, fmt):
    """An x that starts off a 16-byte boundary is copied, not misread."""
    qt = _qt(fmt, 512, 256, 5, dev)
    flat = _x(1, 33 * 512 + 1, 6, dev)[0]
    x = flat[1:].view(33, 512)                # contiguous, 2 bytes into its storage
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    _assert_close(x, qt)
