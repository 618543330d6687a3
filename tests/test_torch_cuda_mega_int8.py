"""The int8-activation q8_0 matmul (csrc/qmm_int8.cu, kernel row 6) and the DiT
Euler-step megakernel (csrc/dit_mega.cu, row 12) against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (CUDA kernels have no
CPU mode).  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mega_int8.py -q

Tolerances: row 6 bit-identical (both sum the same exact f32 terms in K order),
at every layer-scan shape of request B, for layer li != 0 of a stacked weight,
and on a rerun.
Row 12 (at T = 128, 256 and a ragged 40; Lc = 320 and 64): two correct
summation orders of the megakernel's f32 sums part a little, and that grows
with depth; each test measures it (the plain version on the card against the
same on the CPU) and holds the kernel to 1.5x that drift in max abs error over
the output's peak, never tighter than 5e-3 (the JAX megakernel test's absolute
bound, test_dit_mega.py:93, at outputs of order 1), and reruns bit-identical.
"""

import dataclasses

import pytest
import torch

from acestep_tpu_torch import weights
from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops import rope_cos_sin
from acestep_tpu_torch.ops.cuda import dit_mega as tdm
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.cuda import qmm_int8 as tint8
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize, stack_layers

DRIFT_FACTOR = 1.5
MEGA_REL_MIN = 5e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


INT8_SHAPES = [(m, k, n) for m in (1, 4, 16) for k, n in ((1024, 4096), (3072, 1024))] + [
    (1, 256, 2048), (1, 2048, 12288), (5, 1024, 65536), (16, 96, 128)]


@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_act_bit_identical(dev, shape):
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(m * n + k)
    qt = precast_quant_scales({"w": quantize(torch.randn((k, n), generator=g, device=dev)
                                             * 0.02, "q8_0")})["w"]
    x = torch.randn((m, k), generator=g, device=dev)
    x[0, :5] = torch.tensor([0.0, 127.0, 0.5, -1.5, 2.5], device=dev)    # ties at inv = 1
    if m > 2:
        x[2] = 0.0                                                      # a zero row
    for xx in (x.bfloat16(), x):
        n0 = tint8.INT8.launches
        got = tint8.qmm_int8_act(xx, qt)
        assert tint8.INT8.launches == n0 + 1
        ref = tint8.qmm_int8_act_plain(xx, qt)
        assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
        # the plain version on the card and on the CPU agree bit for bit too
        cpu = tint8.qmm_int8_act_plain(xx.cpu(), weights.tree_to({"w": qt}, "cpu")["w"])
        assert torch.equal(ref.cpu(), cpu)


# request B's layer-scan shapes (Qwen3-0.6B: qkv, o_proj, gate-up, down) and the
# codes head, at every batch the planner decodes
LM_SHAPES = [(m, k, n) for m in (1, 2, 4, 8, 16)
             for k, n in ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 65536))]


def _q8(k, n, seed, dev, layers=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = [quantize(torch.randn((k, n), generator=g, device=dev) * 0.02, "q8_0")
          for _ in range(layers or 1)]
    return precast_quant_scales(ws[0] if layers is None else stack_layers(ws)), g


@pytest.mark.parametrize("shape", LM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_act_lm_shapes_bit_identical(dev, shape):
    """Every layer-scan shape of request B: one launch a call, bit-identical
    with the plain version, and a rerun bit-identical."""
    m, k, n = shape
    qt, g = _q8(k, n, m + k + n, dev)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    n0 = tint8.INT8.launches
    got = tint8.qmm_int8_act(x, qt)
    again = tint8.qmm_int8_act(x, qt)
    assert tint8.INT8.launches == n0 + 2
    assert torch.equal(got, tint8.qmm_int8_act_plain(x, qt)) and torch.equal(got, again)


def test_int8_act_stacked_layer_in_place(dev):
    """Layer li != 0 of a stacked weight, read through base + li layer
    strides: the plain version of the layer's view, bit for bit."""
    qt, g = _q8(1024, 4096, 3, dev, layers=3)
    x = torch.randn((2, 1024), generator=g, device=dev).bfloat16()
    for li in (1, 2):
        got = tint8.qmm_int8_act(x, qt, li)
        assert torch.equal(got, tint8.qmm_int8_act_plain(x, qt.layer(li)))
        assert torch.equal(tqmm.qmm_stacked_nd(x[None], qt, li, int8_act=True)[0], got)


def test_int8_act_smem_matches_the_kernel(dev):
    """The plan's shared-memory mirror equals the kernel's own layout."""
    from acestep_tpu_torch.ops.cuda import _build
    for m, k, n in LM_SHAPES + INT8_SHAPES:
        bn, splits = tint8.int8_plan(m, k, n)
        assert _build.lib().acestep_qmm_int8_smem(m, k, bn, splits) == \
            tint8.int8_smem(m, k, bn, splits)


def test_int8_dispatch_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    qt = precast_quant_scales({"w": quantize(torch.randn((512, 200), generator=g, device=dev)
                                             * 0.02, "q8_0")})["w"]
    x = torch.randn((4, 512), generator=g, device=dev).bfloat16()
    n_int8, n_q8 = tint8.INT8.launches, tqmm.KERNELS["q8_0"].launches
    tqmm.qmm_nd(x, qt, int8_act=True)                  # N % 128 != 0: the q8_0 kernel
    assert tint8.INT8.launches == n_int8 and tqmm.KERNELS["q8_0"].launches == n_q8 + 1


def mega_case(cfg, n_layers, t, lc, seed, dev, padded=False):
    """Random decoder layers (q8_0, fused, f32 scales; norms and the
    modulation table drawn, not constant) and inputs of one Euler step."""
    init = RandomInit(torch.device(dev), seed, "q8_0")
    h, d = cfg.hidden_size, cfg.head_dim

    def around_one(*shape):
        return (1.0 + 0.1 * init.normal(shape, 1.0)).bfloat16()

    sa, ca = init.attn(cfg, n_layers), init.attn(cfg, n_layers)
    for a in (sa, ca):
        a["q_norm"], a["k_norm"] = around_one(n_layers, d), around_one(n_layers, d)
    layers = {"self_attn_norm": around_one(n_layers, h), "self_attn": sa,
              "cross_attn_norm": around_one(n_layers, h), "cross_attn": ca,
              "mlp_norm": around_one(n_layers, h),
              "mlp": init.mlp(h, cfg.intermediate_size, n_layers),
              "scale_shift_table": (0.1 * init.normal((n_layers, 6, h), 1.0)).bfloat16()}
    layers = precast_quant_scales(dit.fuse_params({"layers": layers})["layers"])
    hkv = cfg.num_key_value_heads
    x = init.normal((1, t, h), 1.0)
    kst, vst = (init.normal((n_layers, 1, hkv, lc, d), 1.0).bfloat16() for _ in range(2))
    tproj = init.normal((1, 6, h), 0.3)
    cos, sin = (a.bfloat16().float() for a in rope_cos_sin(torch.arange(t, device=dev), d,
                                                            base=cfg.rope_theta))
    encm = torch.zeros((1, lc), device=dev)
    if padded:
        encm[:, lc - lc // 5:] = tdm.NEG
    flags = [lt == "sliding_attention" for lt in cfg.layer_types[:n_layers]]
    return layers, (x, kst, vst, tproj, cos, sin, flags, encm)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


FULL = DiTConfig()
BAND = dataclasses.replace(FULL, sliding_window=16)


@pytest.mark.parametrize("cfg,n_layers,padded,t,lc", [
    (FULL, 2, False, 128, 320), (FULL, 2, True, 128, 320), (BAND, 2, True, 128, 320),
    (FULL, 24, True, 128, 320), (FULL, 2, True, 256, 320), (FULL, 2, True, 40, 320),
    (FULL, 2, True, 128, 64), (FULL, 2, True, 128, 640)],
    ids=["2L", "2L-padded", "2L-band16", "24L-padded", "2L-T256", "2L-T40", "2L-Lc64-padded",
         "2L-Lc640-padded"])
def test_dit_mega_vs_plain(dev, cfg, n_layers, padded, t, lc):
    """T = 256 runs two GEMM passes of 128 tokens; T = 40 a ragged token
    tile (and a ragged query block); Lc = 64 one key chunk; Lc = 640 streams
    every K / V chunk (past the 320 keys whose K chunks stay in shared
    memory)."""
    cfg = dataclasses.replace(cfg, num_hidden_layers=n_layers,
                              layer_types=cfg.layer_types[:n_layers])
    layers, args = mega_case(cfg, n_layers, t, lc, n_layers, dev, padded)
    assert tdm.supported(layers, cfg, 1, t, lc)
    n0 = tdm.MEGA.launches
    got = tdm.dit_layers_mega(layers, cfg, *args)
    torch.cuda.synchronize()
    assert tdm.MEGA.launches == n0 + 1 and got.shape == (1, t, cfg.hidden_size)
    assert bool(torch.isfinite(got).all())
    ref = tdm.dit_layers_mega_plain(layers, cfg, *args)
    cpu = tdm.dit_layers_mega_plain(weights.tree_to(layers, "cpu"), cfg,
                                    *(a.cpu() if isinstance(a, torch.Tensor) else a
                                      for a in args))
    bound = max(MEGA_REL_MIN, DRIFT_FACTOR * _rel(ref.cpu(), cpu))
    assert _rel(got, ref) < bound, (_rel(got, ref), bound)
    again = tdm.dit_layers_mega(layers, cfg, *args)
    assert torch.equal(got, again)                    # no atomics: reruns are identical
    if cfg.sliding_window < 128:                      # the band is applied and matters
        no_band = tdm.dit_layers_mega_plain(layers, cfg, *args[:6], [False] * n_layers,
                                            args[7])
        assert _rel(no_band, ref) > bound


def test_dit_mega_smem_matches_the_kernel(dev):
    """The wrapper's shared-memory mirror equals the kernel's entry point,
    and the launch's grid is a whole number of clusters that fit."""
    from acestep_tpu_torch.ops.cuda import _build
    assert _build.lib().acestep_dit_mega_smem() == tdm.SMEM
    grid = tdm.default_grid(torch.device("cuda"))
    assert grid > 0 and grid % tdm.CS == 0


def test_dit_mega_refused_launch_raises(dev):
    cfg = dataclasses.replace(FULL, num_hidden_layers=2, layer_types=FULL.layer_types[:2])
    layers, args = mega_case(cfg, 2, 128, 320, 0, dev)
    with pytest.raises(RuntimeError, match="acestep_dit_mega"):
        tdm.dit_layers_mega(layers, cfg, *args, grid=1 << 20)
    torch.cuda.synchronize()
    got = tdm.dit_layers_mega(layers, cfg, *args)      # the next launch still runs
    assert _rel(got, tdm.dit_layers_mega_plain(layers, cfg, *args)) < MEGA_REL_MIN
