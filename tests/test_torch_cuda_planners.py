"""The kernels of the 1.7B and 4B LM planners' decode step against their plain
PyTorch versions, on the card: row 6 (csrc/qmm_int8.cu) at every layer linear
and the reduced codes head at M 1-16, rows 9-10 (csrc/decode_attn.cu) at 32
query and 8 KV heads, and row 1 (csrc/qmm_wgmma.cu) at the planners' shapes.

At hidden 2048 and 2560 row 11 declines (it takes hidden 1024 only, as the JAX
megakernel does), so the decode step runs the layer scan, whose linears and
attention are these rows.

Every test here needs an NVIDIA GPU and skips without one (CUDA kernels have no
CPU mode).  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_planners.py -q

Tolerances: row 6 bit-identical (both sum the same exact f32 terms in K order)
and its plan's shared memory equal to the kernel's own layout; rows 9-10 the
JAX kernel test's 2e-2 (absolute and relative), the fused kernel's new K/V
int8 within 2 and scales to rtol 2e-2; row 1 atol 1e-2 with rtol 1e-2, as
tests/test_torch_cuda_kernels.py.
"""

import pytest
import torch

from acestep_tpu_torch.config import QWEN3_1_7B, QWEN3_4B
from acestep_tpu_torch.ops.cuda import decode_attn as tattn
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.cuda import qmm_int8 as tint8
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize
from acestep_tpu_torch.serving import kv_cache as tkvc
from acestep_tpu_torch.serving import lm as tlm

ATTN_TOL = 2e-2
INT8_MAX_DIFF = 2
QMM_ATOL = 1e-2
QMM_RTOL = 1e-2
CODES_HEAD_N = 65536          # the reduced codes head: 64000 codes + EOS, padded to 2048s

pytestmark = pytest.mark.cuda


def planner_linears(cfg):
    """(name, K, N) of a planner's q8_0 linears as the fused serving tree holds
    them: qkv, o_proj, gate-up, down_proj, and the reduced codes head."""
    h, qd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    return [("qkv", h, qd + 2 * kvd), ("o_proj", qd, h),
            ("gate_up", h, 2 * cfg.intermediate_size), ("down_proj", cfg.intermediate_size, h),
            ("codes_head", h, CODES_HEAD_N)]


LINEARS = [(label, *lin) for label, cfg in (("1.7B", QWEN3_1_7B), ("4B", QWEN3_4B))
           for lin in planner_linears(cfg)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _q8(k, n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = precast_quant_scales(quantize(torch.randn((k, n), generator=g, device=dev) * 0.02,
                                       "q8_0"))
    return qt, g


@pytest.mark.parametrize("planner,name,k,n", LINEARS, ids=lambda v: str(v))
def test_int8_act_planner_linears_bit_identical(dev, planner, name, k, n):
    """Every M of 1-16 at one linear: one launch a call, bit-identical with the
    plain version, a rerun bit-identical; the plan's shared memory as the
    kernel lays it out (the 4B's down_proj at M 10-16 and o_proj at M 16 had
    no plan whose shared memory fit before the xq ring)."""
    from acestep_tpu_torch.ops.cuda import _build

    qt, g = _q8(k, n, k + n, dev)
    for m in range(1, tint8.MAX_M + 1):
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        bn, splits = tint8.int8_plan(m, k, n)
        assert _build.lib().acestep_qmm_int8_smem(m, k, bn, splits) == \
            tint8.int8_smem(m, k, bn, splits) <= tint8.SMEM_MAX
        n0 = tint8.INT8.launches
        got = tint8.qmm_int8_act(x, qt)
        again = tint8.qmm_int8_act(x, qt)
        assert tint8.INT8.launches == n0 + 2
        ref = tint8.qmm_int8_act_plain(x, qt)
        assert torch.equal(got, ref), (planner, name, m, (bn, splits))
        assert torch.equal(got, again)


# (B, T, lengths): one 1024-position T block; two and four blocks; the batch of
# 16 of an int8_act codes phase
ATTN_CASES = [(1, 1024, [1]), (4, 1024, [64, 65, 1000, 1024]), (2, 2048, [1025, 2048]),
              (8, 4096, [1, 128, 129, 1000, 2049, 3000, 4095, 4096]),
              (16, 1024, [1 + 63 * i for i in range(16)])]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"b{c[0]}-t{c[1]}")
def test_decode_attn_at_the_4b_heads(dev, case):
    """Rows 9 and 10 at the 4B's 32 query and 8 KV heads (a group of 4), at
    layers 0 and 35 of a 36-layer cache."""
    b, t_max, lengths = case
    hq, hkv, n_l = QWEN3_4B.num_attention_heads, QWEN3_4B.num_key_value_heads, 36
    assert tattn.takes(hq, hkv, 128, t_max)
    g = torch.Generator(device=dev).manual_seed(t_max + b)
    kq, ks = tkvc.quantize_kv(torch.randn((n_l, b, hkv, t_max, 128), generator=g, device=dev))
    vq, vs = tkvc.quantize_kv(torch.randn((n_l, b, hkv, t_max, 128), generator=g, device=dev))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, 128), generator=g, device=dev).bfloat16()
    k_self, v_self = (torch.randn((b, hkv, 128), generator=g, device=dev).bfloat16()
                      for _ in range(2))
    qn, kn = (torch.randn(128, generator=g, device=dev) for _ in range(2))
    cos, sin = (t[:, 0] for t in tlm._rope_at(lens, 128, 1e6))
    for li in (0, n_l - 1):
        args = (q, kq, ks, vq, vs, lens, li, k_self, v_self)
        n0 = tattn.ATTN.launches
        got = tattn.decode_attention_int8_stacked(*args)
        assert tattn.ATTN.launches > n0
        torch.testing.assert_close(got, tattn.decode_attention_plain(*args), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
        fargs = (q, k_self, v_self, qn, kn, cos, sin, kq, ks, vq, vs, lens, li)
        n0 = tattn.FUSED.launches
        got_f = tattn.decode_attention_fused_stacked(*fargs)
        assert tattn.FUSED.launches > n0
        ref_f = tattn.decode_attention_fused_plain(*fargs)
        torch.testing.assert_close(got_f[0], ref_f[0], atol=ATTN_TOL, rtol=ATTN_TOL)
        for i in (1, 3):
            assert int((got_f[i].int() - ref_f[i].int()).abs().max()) <= INT8_MAX_DIFF
        for i in (2, 4):
            torch.testing.assert_close(got_f[i], ref_f[i], rtol=2e-2, atol=1e-6)


@pytest.mark.parametrize("planner,name,k,n", LINEARS, ids=lambda v: str(v))
def test_qmm_at_the_planner_shapes(dev, planner, name, k, n):
    """Row 1 at M 1 (a decode step), 16 (a batch of 16 or a 16-token suffix)
    and 64 (a prompt bucket's prefill)."""
    qt, g = _q8(k, n, 3 * k + n, dev)
    for m in (1, 16, 64):
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        n0 = tqmm.KERNELS["q8_0"].launches
        got = tqmm.qmm(x, qt).float()
        assert tqmm.KERNELS["q8_0"].launches == n0 + 1
        torch.testing.assert_close(got, tqmm.qmm_plain(x, qt).float(), atol=QMM_ATOL,
                                   rtol=QMM_RTOL)
