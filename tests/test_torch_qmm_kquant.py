"""Host-side pieces of the q4_k / q6_k kernels (csrc/qmm_kquant.cu) on the CPU:
the block height and K split chosen per shape (``kquant_plan``), the fold
groups each split takes, the layer-offset arithmetic that reads layer ``li`` of
a stacked weight through base pointers (``field_ptrs``), and the checks the
wrapper makes before it builds or launches anything.

The plan is held over every quantized matmul shape that a batch-1 request
sends at 256, 1536 and 3072 latent frames (chip_smoke.main_path_shapes: the
10 s, 60 s and 120 s buckets).  The kernels themselves run only on the card
(tests/test_torch_cuda_qmm_kquant.py); their CPU stand-in, ``qmm_plain``, is
held to the JAX package's Pallas kernels in tests/test_torch_qmm_formats.py.
"""

import math

import pytest
import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import FOLD, quantize, stack_layers
from chip_smoke import main_path_shapes

FRAMES = (256, 1536, 3072)
BLOCK_M = (16, 64, 128)             # the kernels' block heights


def split_groups(k, splits):
    """The fold groups each K split takes, by the kernel's rule (qmm_kquant.cu
    ``launch``): ceil(groups / splits) a split, the last one short."""
    groups = k // FOLD
    per = math.ceil(groups / splits)
    return [range(z * per, min((z + 1) * per, groups)) for z in range(splits)]


# every 4-bit-capable (K % 256 == 0) shape of the three buckets
SHAPES = sorted({(f, s) for f in FRAMES
                 for s in main_path_shapes(DiTConfig(), QwenConfig(), frames=f)
                 if s[1] % FOLD == 0})


@pytest.mark.parametrize("frames,shape", SHAPES)
def test_plan_covers_the_shape(frames, shape):
    m, k, n = shape
    bm, splits = tqmm.kquant_plan(m, k, n)
    assert bm in BLOCK_M
    row_tiles, col_tiles = math.ceil(m / bm), math.ceil(n / tqmm.KQ_TN)
    # the tiles cover M and N, and no tile lies wholly outside them
    assert row_tiles * bm >= m > (row_tiles - 1) * bm
    assert col_tiles * tqmm.KQ_TN >= n > (col_tiles - 1) * tqmm.KQ_TN
    # the smallest wgmma width that holds M, up to 128 rows
    if m <= 128:
        assert bm == min(b for b in BLOCK_M if b >= m)
    # K splits fall on fold groups: contiguous, non-empty, covering K
    groups = k // FOLD
    ranges = split_groups(k, splits)
    assert len(ranges) == splits and all(len(r) > 0 for r in ranges)
    assert [g for r in ranges for g in r] == list(range(groups))
    # a split only where the tiles leave more than half of the card idle, and
    # then enough blocks to stream the weight, within one wave
    tiles = row_tiles * col_tiles
    if splits > 1:
        assert tiles <= tqmm.SMS // 2
        assert tiles * splits <= tqmm.SMS
        assert tiles * splits >= min(tqmm.SMS // 2, tiles * groups)
    else:
        assert tiles > tqmm.SMS // 2 or groups == 1 or tqmm.SMS // tiles <= 1


@pytest.mark.parametrize("m,k,n", [(0, 256, 128), (4, 0, 128), (4, 300, 128),
                                   (4, 256, 0), (4, 128, 64)])
def test_plan_rejects_what_the_kernel_does_not_take(m, k, n):
    with pytest.raises(ValueError):
        tqmm.kquant_plan(m, k, n)


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8, 12, 24])
def test_every_split_count_the_plan_gives_leaves_no_split_empty(groups):
    """The kernel refuses a split count that would leave a split without a
    fold group; the plan's normalisation only gives counts it accepts."""
    k = groups * FOLD
    for tiles in range(1, tqmm.SMS // 2 + 1):
        splits = min(groups, tqmm.SMS // tiles)
        splits = math.ceil(groups / math.ceil(groups / splits))
        ranges = split_groups(k, splits)
        assert all(len(r) > 0 for r in ranges)
        assert sum(len(r) for r in ranges) == groups


def _stacked(fmt, layers=3, k=512, n=64):
    g = torch.Generator().manual_seed(0)
    return precast_quant_scales(stack_layers(
        [quantize(torch.randn((k, n), generator=g) * 0.05, fmt) for _ in range(layers)]))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q6_k"])
def test_layer_pointers_are_the_layer_views(fmt):
    """Layer li's field pointers (base + li layer strides) are those of the
    view ``qt.layer(li)``, for every field the kernel reads."""
    st = _stacked(fmt)
    fields = [f for f, _, _ in tqmm.KERNELS[fmt].fields]
    for li in (0, 1, 2, -1):
        want = [getattr(st.layer(li), f).data_ptr() for f in fields]
        assert tqmm.field_ptrs(st, torch.device("cpu"), li) == want
    with pytest.raises(IndexError):
        tqmm.field_ptrs(st, torch.device("cpu"), 3)
    with pytest.raises(ValueError):
        tqmm.field_ptrs(st, torch.device("cpu"))               # a stacked weight needs li
    with pytest.raises(ValueError):
        tqmm.field_ptrs(st.layer(0), torch.device("cpu"), 0)   # a 2-D one takes none


def test_field_checks_are_kept_and_redone_when_a_field_changes():
    st = _stacked("q4_k")
    cpu = torch.device("cpu")
    first = tqmm.field_ptrs(st, cpu, 1)
    assert st.__dict__["_kernel_fields"][0] == cpu
    assert tqmm.field_ptrs(st, cpu, 1) == first
    st.sub_mins = st.sub_mins.clone()               # a new tensor: checked and read anew
    again = tqmm.field_ptrs(st, cpu, 1)
    assert again[2] == st.layer(1).sub_mins.data_ptr() != first[2]
    st.super_scales = st.super_scales.half()        # f16 scales: the kernel reads f32
    with pytest.raises(ValueError):
        tqmm.field_ptrs(st, cpu, 1)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
def test_wrapper_raises_before_any_launch(fmt):
    """What the kernel cannot take raises in the wrapper, before the kernels
    are built or launched (CPU tensors stand in for the card's)."""
    qt = precast_quant_scales(quantize(torch.randn((512, 64)) * 0.05, fmt))
    x = torch.zeros((4, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tqmm._launch(torch.zeros((4, 256), dtype=torch.bfloat16), qt, None, torch.bfloat16)
    with pytest.raises(ValueError):
        tqmm._launch(x, quantize(torch.randn((512, 64)), fmt), None, torch.bfloat16)
    with pytest.raises(ValueError):
        tqmm._launch(x, qt, None, torch.float16)
    with pytest.raises(ValueError):
        tqmm._launch(x, qt, torch.zeros(63), torch.bfloat16)
    strided = qt.map(lambda a: a.t().contiguous().t())      # a field not row-major
    with pytest.raises(ValueError):
        tqmm._launch(x, strided, None, torch.bfloat16)


@pytest.mark.parametrize("fmt", ["q4_k", "q6_k"])
def test_layer_index_on_the_cpu_path(fmt):
    """``qmm(..., li=)`` and the stacked entry points give layer li's product
    on the CPU (the plain version of the layer view)."""
    st = _stacked(fmt)
    x = torch.randn((5, 512), generator=torch.Generator().manual_seed(1)).bfloat16()
    for li in range(3):
        want = tqmm.qmm_plain(x, st.layer(li))
        assert torch.equal(tqmm.qmm(x, st, li=li), want)
        assert torch.equal(tqmm.qmm_stacked(x, st, li), want)
        assert torch.equal(tqmm.qmm_stacked_nd(x[None], st, li)[0], want)
