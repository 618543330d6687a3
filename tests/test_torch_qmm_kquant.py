"""Host-side pieces of the dequant-matmul kernel (csrc/qmm_wgmma.cu: q8_0, q4_0,
q4_k, q6_k) on the CPU: the block height and K split chosen per shape
(``wgmma_plan``), the K steps each split takes, the layer-offset arithmetic
that reads layer ``li`` of a stacked weight through base pointers
(``field_ptrs``), and the checks the wrapper makes before it builds or
launches anything.

The plan is held over every quantized matmul shape that a batch-1 request
sends at 256, 1536 and 3072 latent frames (chip_smoke.main_path_shapes: the
10 s, 60 s and 120 s buckets), for each format that can hold it, and over the
LM planner's q8_0 shapes.  The kernel itself runs only on the card
(tests/test_torch_cuda_qmm_kquant.py); its CPU stand-in, ``qmm_plain``, is
held to the JAX package's Pallas kernels in tests/test_torch_qmm_formats.py.
"""

import math

import pytest
import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize, stack_layers
from chip_smoke import main_path_shapes

FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
FRAMES = (256, 1536, 3072)
BLOCK_M = (16, 64, 128)             # the kernel's block heights
# the 0.6B LM planner's q8_0 products (K, N): fused qkv, o_proj, fused
# gate-up, down, the reduced codes head; at decode (M = 1), batch 4 and a
# prefill of the codes phase's prompt
LM_KN = ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 65536))
LM_SHAPES = [(m, k, n) for m in (1, 4, 290) for k, n in LM_KN]


def split_steps(k, splits):
    """The K steps each split takes, by the kernel's rule (qmm_wgmma.cu
    ``launch``): ceil(steps / splits) a split, the last one short."""
    steps = math.ceil(k / tqmm.STEP)
    per = math.ceil(steps / splits)
    return [range(z * per, min((z + 1) * per, steps)) for z in range(splits)]


# (format, where the shape comes from, shape): every shape of the three buckets
# that the format can hold (4-bit: K % 256 == 0), and the LM's q8_0 shapes
SHAPES = sorted({(fmt, f"{f} frames", s) for f in FRAMES
                 for s in main_path_shapes(DiTConfig(), QwenConfig(), frames=f)
                 for fmt in FORMATS if s[1] % tqmm.K_ALIGN[fmt] == 0}
                | {("q8_0", "LM", s) for s in LM_SHAPES})


@pytest.mark.parametrize("fmt,source,shape", SHAPES)
def test_plan_covers_the_shape(fmt, source, shape):
    m, k, n = shape
    bm, splits = tqmm.wgmma_plan(fmt, m, k, n)
    assert bm in BLOCK_M
    row_tiles, col_tiles = math.ceil(m / bm), math.ceil(n / tqmm.TILE_N)
    # the tiles cover M and N, and no tile lies wholly outside them
    assert row_tiles * bm >= m > (row_tiles - 1) * bm
    assert col_tiles * tqmm.TILE_N >= n > (col_tiles - 1) * tqmm.TILE_N
    # the smallest wgmma width that holds M, up to 128 rows
    if m <= 128:
        assert bm == min(b for b in BLOCK_M if b >= m)
    # K splits fall on K steps: contiguous, non-empty, covering K; a q8_0 K that
    # is not a multiple of the step ends in a partial step
    steps = math.ceil(k / tqmm.STEP)
    ranges = split_steps(k, splits)
    assert len(ranges) == splits and all(len(r) > 0 for r in ranges)
    assert [s for r in ranges for s in r] == list(range(steps))
    assert (steps * tqmm.STEP > k) == (k % tqmm.STEP != 0)
    assert steps * tqmm.STEP - k < tqmm.STEP
    # a split only where the tiles leave more than half of the card idle, one
    # cluster of at most MAX_SPLITS blocks a tile, within one wave, each block
    # taking as few steps as those limits allow
    tiles = row_tiles * col_tiles
    assert splits <= tqmm.MAX_SPLITS
    if splits > 1:
        assert tiles <= tqmm.SMS // 2
        assert tiles * splits <= tqmm.SMS
        limit = min(steps, tqmm.SMS // tiles, tqmm.MAX_SPLITS)
        assert math.ceil(steps / splits) == math.ceil(steps / limit)
    else:
        assert tiles > tqmm.SMS // 2 or steps == 1 or tqmm.SMS // tiles <= 1


def test_plan_keeps_a_split_within_one_wave_of_clusters():
    """Where the card holds fewer clusters than its SMs would (a cluster takes
    SMs of one GPC), the plan trades splits for waves: it takes the count whose
    blocks run the fewest steps one after the other."""
    def scarce(fmt, bm, splits):
        return 14 if splits == 8 else tqmm.ideal_clusters(fmt, bm, splits)

    # 16 tiles of 16 steps: 8 splits of 2 steps, or, with room for only 14
    # clusters of 8, two waves of them (4 steps in sequence) against one wave
    # of 6 splits of 3 steps
    assert tqmm.wgmma_plan("q8_0", 128, 2048, 2048) == (128, 8)
    assert tqmm.wgmma_plan("q8_0", 128, 2048, 2048, scarce) == (128, 6)
    # no split at all where each count would take more steps in sequence
    assert tqmm.wgmma_plan("q4_k", 64, 1024, 1024, lambda f, b, s: 1) == (64, 1)


@pytest.mark.parametrize("fmt,m,k,n", [
    ("q4_k", 0, 256, 128), ("q4_k", 4, 0, 128), ("q4_k", 4, 300, 128),
    ("q4_k", 4, 256, 0), ("q4_k", 4, 128, 64), ("q4_0", 4, 128, 64), ("q6_k", 4, 384, 64),
    ("q8_0", 0, 256, 128), ("q8_0", 4, 0, 128), ("q8_0", 4, 48, 128), ("q8_0", 4, 96, 0),
    ("q5_1", 4, 256, 128)])
def test_plan_rejects_what_the_kernel_does_not_take(fmt, m, k, n):
    with pytest.raises(ValueError):
        tqmm.wgmma_plan(fmt, m, k, n)


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 8, 12, 24, 48])
def test_every_split_count_the_plan_gives_leaves_no_split_empty(steps):
    """The kernel refuses a split count that would leave a split without a
    K step; the plan's normalisation only gives counts it accepts."""
    k = steps * tqmm.STEP
    for tiles in range(1, tqmm.SMS // 2 + 1):
        splits = min(steps, tqmm.SMS // tiles, tqmm.MAX_SPLITS)
        splits = math.ceil(steps / math.ceil(steps / splits))
        for kk in (k, k - 32, k - 96):            # whole, and a ragged last step
            if kk <= 0 or math.ceil(kk / tqmm.STEP) != steps:
                continue
            ranges = split_steps(kk, splits)
            assert all(len(r) > 0 for r in ranges)
            assert sum(len(r) for r in ranges) == steps


def _stacked(fmt, layers=3, k=512, n=64):
    g = torch.Generator().manual_seed(0)
    return precast_quant_scales(stack_layers(
        [quantize(torch.randn((k, n), generator=g) * 0.05, fmt) for _ in range(layers)]))


@pytest.mark.parametrize("fmt", FORMATS)
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


@pytest.mark.parametrize("fmt", FORMATS)
def test_wrapper_raises_before_any_launch(fmt):
    """What the kernel cannot take raises in the wrapper, before the kernel
    is built or launched (CPU tensors stand in for the card's)."""
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


@pytest.mark.parametrize("fmt", FORMATS)
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
