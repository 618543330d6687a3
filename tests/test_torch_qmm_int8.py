"""Port parity of the int8-activation q8_0 matmul (kernel row 6,
acestep_tpu_torch/ops/cuda/qmm_int8.py) and its opt-in dispatch against the
JAX package, on the CPU.

The JAX side runs ``qmm_int8_act`` in Pallas interpret mode, and ``linear`` /
the LM decode step on the pallas backend with ``ACESTEP_TPU_INT8_ACT=1`` (its
``qmm_pallas_nd`` patched to interpret mode, as tests/test_qmm_pallas.py does).

Tolerances:
  * the row quantizer: int8 values and row scales exactly equal;
  * the matmul: within one bf16 step of the reference (rtol 2^-7) with at
    least 99% of the outputs exactly equal: both sum the same exact f32 terms
    in K order, and the JAX interpret run's bf16 rounding of its f32 result
    is the only place they can part; plus test_qmm_int8.py's own bound
    against the bf16 dequant reference (mean |err| / mean |ref| < 0.02,
    max < 0.15);
  * the LM layer scan: every int8 matmul bit-identical to the JAX kernel on
    the same inputs; logits within 4e-2 of their peak (see the test) and
    greedy tokens equal.
"""

import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import acestep_tpu.ops.pallas.qmm as jqmm
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.ops import qlinear as jqlinear
from acestep_tpu.quant import QuantTensor as JQuantTensor
from acestep_tpu.quant import dequantize as jdequantize
from acestep_tpu.quant import quantize_np, quantize_tree_jax
from acestep_tpu.serving import kv_cache as jkvc
from acestep_tpu.serving import lm as jlm
from acestep_tpu_torch import weights
from acestep_tpu_torch.ops import linear as tlinear
from acestep_tpu_torch.ops.cuda import qmm_int8 as tint8
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import quantize, stack_layers
from acestep_tpu_torch.serving import lm as tlm
from tests.test_torch_lm_serving import WIDE, _caches, _prompt, _sampler, tcfg_of

BF16_STEP = 2.0 ** -7
EQUAL_MIN = 0.99
LOGIT_REL_INT8 = 4e-2


def _qt_pair(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    jqt = quantize_np(w, "q8_0")
    return jqt, weights.from_jax_numpy({"w": jqt})["w"]


def _x(m, k, seed):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _one_step(got, ref):
    """Within one bf16 step of ``ref`` everywhere; the share exactly equal."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.all(np.abs(got - ref) <= BF16_STEP * np.abs(ref) + 1e-30), \
        np.abs(got - ref).max()
    return float(np.mean(got == ref))


@pytest.fixture
def pallas_int8(monkeypatch):
    """The JAX package on its pallas backend with the int8 switch on, its
    kernels in interpret mode; counts the int8 kernel's calls."""
    calls = {"int8": 0}
    real_nd, real_int8 = jqmm.qmm_pallas_nd, jqmm.qmm_int8_act

    def int8_spy(x, qt, **kw):
        calls["int8"] += 1
        return real_int8(x, qt, **kw)

    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "pallas")
    monkeypatch.setenv("ACESTEP_TPU_INT8_ACT", "1")
    monkeypatch.setattr(jqmm, "qmm_int8_act", int8_spy)
    monkeypatch.setattr(jqmm, "qmm_pallas_nd", lambda x, qt, **kw: real_nd(x, qt,
                                                                          interpret=True))
    return calls


@pytest.fixture
def port_int8_calls(monkeypatch):
    """Counts the port's calls of the int8 kernel's plain version."""
    calls = {"int8": 0}
    real = tint8.qmm_int8_act_plain

    def spy(x, qt):
        calls["int8"] += 1
        return real(x, qt)

    monkeypatch.setattr(tint8, "qmm_int8_act_plain", spy)
    return calls


def test_quantize_rows_matches_jax():
    """qmm.py:406-411, a zero row and a row with a half-way product included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 512)).astype(np.float32)
    x[2] = 0.0
    x[4, :3] = [127.0, 0.5, -1.5]          # inv = 1: 0.5 and -1.5 round to even
    x[4, 3:] = 0.25
    for xj, xt in ((jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()),
                   (jnp.asarray(x), torch.from_numpy(x))):
        xf = xj.astype(jnp.float32)
        amax = jnp.max(jnp.abs(xf), axis=1, keepdims=True)
        xs = amax / 127.0
        inv = jnp.where(xs > 0, 1.0 / jnp.maximum(xs, 1e-30), 0.0)
        xq = jnp.clip(jnp.round(xf * inv), -127, 127).astype(jnp.int8)
        got_q, got_s = tint8.quantize_rows(xt)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(xs)[:, 0])
    assert int(got_q[2].abs().max()) == 0 and float(got_s[2]) == 0.0
    assert got_q[4, :3].tolist() == [127, 0, -2]


@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("k,n", [(256, 256), (512, 384), (1024, 512)])
def test_plain_matches_interpret_kernel(m, k, n):
    """bk = K at K = 256 (the DiT's linear_1), bk = 512 beyond."""
    jqt, tqt = _qt_pair(k, n, 10 * m + k)
    xj, xt = _x(m, k, m + n)
    ref = np.asarray(jqmm.qmm_int8_act(xj, jqt, interpret=True), np.float32)
    got = tint8.qmm_int8_act(xt, tqt)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    assert _one_step(got, ref) >= EQUAL_MIN
    fp = np.asarray(jnp.dot(xj, jdequantize(jqt, jnp.bfloat16),
                            preferred_element_type=jnp.float32), np.float32)
    denom = np.abs(fp).mean() + 1e-9
    assert np.abs(got - fp).mean() / denom < 0.02
    assert np.abs(got - fp).max() / denom < 0.15


@pytest.mark.parametrize("m,n,bias,route", [
    (16, 256, False, "int8"),
    (17, 256, False, "q8_0"),
    (4, 200, False, "q8_0"),      # N % 128 != 0: the JAX bf16 fallback
    (1, 384, True, "int8"),
])
def test_linear_dispatch_matches_jax(pallas_int8, port_int8_calls, m, n, bias, route):
    jqt, tqt = _qt_pair(512, n, n + m)
    xj, xt = _x(m, 512, 7 * m)
    b = (np.random.default_rng(3).standard_normal(n) * 0.5).astype(np.float32)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    ref = np.asarray(jqlinear.linear(xj, jqt, jb), np.float32)
    got = tlinear(xt, tqt, tb, int8_act=True)
    assert got.dtype == torch.bfloat16
    # the JAX package enters qmm_int8_act at M <= 16 and falls back inside it
    # where N % 128 != 0; the port decides before it
    assert pallas_int8["int8"] == (m <= 16)
    assert port_int8_calls["int8"] == (route == "int8")
    assert _one_step(got.float().numpy(), ref) >= EQUAL_MIN
    if bias:
        # two roundings: the kernel's bf16 output, then + bias in f32 and bf16 again
        y = tint8.qmm_int8_act_plain(xt, tqt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      (y.float() + tb).bfloat16().float().numpy())
    port_int8_calls["int8"] = 0
    tlinear(xt, tqt, tb)
    assert port_int8_calls["int8"] == 0                     # the knob off: no int8 route


def _jax_int8(x: torch.Tensor, qt) -> np.ndarray:
    """The JAX kernel (interpret mode) on the port's own inputs."""
    jq = JQuantTensor("q8_0", tuple(qt.shape), jnp.asarray(qt.data.numpy()),
                      scales=jnp.asarray(qt.scales.float().numpy()))
    xj = jnp.asarray(x.float().numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    return np.asarray(jqmm.qmm_int8_act(xj, jq, interpret=True), np.float32)


def test_lm_layer_scan_int8_matches_jax(pallas_int8, monkeypatch):
    """decode_step on the layer scan (decode_mega 0) with every layer linear and
    the head through the int8 route, three greedy steps, at the 256-wide q8_0
    LM of tests/test_torch_lm_serving.py.

    Every int8 matmul the port runs in the first step is bit-identical to the JAX kernel run on
    the same inputs.  The logits are held to LOGIT_REL_INT8 = 4e-2 of their
    peak, twice the JAX decode test's 2e-2: int8 activations amplify the bf16
    rounding differences of the surrounding ops (XLA fuses where PyTorch
    rounds each op), since one bf16 step of an activation can move its int8
    value by a whole step of amax / 127.  Measured here: the two packages part
    by 2.4-2.8e-2 of the peak, as far as the JAX package's own int8 and bf16
    decode steps part from each other (2.6e-2), while with the switch off
    they part by 1.0e-2.  Greedy tokens are equal at every step."""
    monkeypatch.setenv("ACESTEP_TPU_DECODE_MEGA", "0")
    calls = {"int8": 0, "checked": 0}
    real = tint8.qmm_int8_act_plain

    def checked(x, qt):
        y = real(x, qt)
        if calls["int8"] < 4 * 2 + 1:          # the first step's
            np.testing.assert_array_equal(y.float().numpy(), _jax_int8(x, qt))
            calls["checked"] += 1
        calls["int8"] += 1
        return y

    monkeypatch.setattr(tint8, "qmm_int8_act_plain", checked)
    p = jqwen.init_params(jax.random.key(0), WIDE, dtype=jnp.bfloat16, scale=1.0,
                          sampler=_sampler(1, 0.05))
    pq = jqwen.stack_params(quantize_tree_jax(p, "q8_0"))
    jp = jlm.fuse_serving_params(jlm.ensure_quantized_head(pq))
    tp = tlm.fuse_serving_params(tlm.ensure_quantized_head(weights.from_jax_numpy(pq)))
    ids, lens = _prompt(7, 2, 20, WIDE.vocab_size, [20, 13])
    jc, tc = _caches(WIDE, 2, 128)
    _, jc = jlm.prefill(jp, WIDE, jnp.asarray(ids), jnp.asarray(lens), jc)
    _, tc = tlm.prefill(tp, tcfg_of(WIDE), torch.from_numpy(ids).long(),
                        torch.from_numpy(lens), tc, int8_act=True)
    pallas_int8["int8"] = calls["int8"] = calls["checked"] = 0
    tok = np.asarray([5, 400], np.int32)
    for step in range(3):
        jl, jc = jlm.decode_step(jp, WIDE, jc, jnp.asarray(tok))
        tl, tc = tlm.decode_step(tp, tcfg_of(WIDE), tc, torch.from_numpy(tok).long(),
                                 decode_mega="0", int8_act=True)
        jc = jkvc.advance(jc, jnp.ones((2,), bool))
        tc.length = tc.length + 1
        j = np.asarray(jl)
        assert np.abs(tl.numpy() - j).max() <= LOGIT_REL_INT8 * np.abs(j).max(), step
        np.testing.assert_array_equal(tl.numpy().argmax(-1), j.argmax(-1))
        tok = j.argmax(-1).astype(np.int32)
    # 4 linears a layer x 2 layers + the head, each step (the JAX side counts
    # traces of its layer scan, not runs)
    assert calls["int8"] == 3 * (4 * 2 + 1) and calls["checked"] == 4 * 2 + 1
    assert pallas_int8["int8"] > 0


# ---------------------------------------------------------------------------
# the kernel's launch plan and its wrapper (no card: a stand-in library takes
# the packed slots)
# ---------------------------------------------------------------------------

# request B's layer-scan shapes (Qwen3-0.6B's qkv, o_proj, gate-up, down), the
# codes head and the DiT's timestep linears
LM_KN = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 65536)]
PLAN_SHAPES = [(m, k, n) for m in (1, 2, 4, 8, 16) for k, n in LM_KN + [
    (256, 2048), (2048, 2048), (2048, 12288), (96, 128), (512, 384)]]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_int8_plan_tiles_and_splits(m, k, n):
    """The column tiles cover N; the K splits are whole, non-empty runs of
    32-blocks that cover K; every block owns at least 4 columns' sums; the
    shared memory stays within the kernel's bound."""
    bn, splits = tint8.int8_plan(m, k, n)
    assert bn in tint8.TILES_N and n % bn == 0 and (n // bn) * bn == n
    assert splits in (1, 2, 4, 8) and bn // splits >= 4
    nkb = k // 32
    per = -(-nkb // splits)
    runs = [(r * per, min(nkb, (r + 1) * per)) for r in range(splits)]
    assert runs[0][0] == 0 and runs[-1][1] == nkb
    assert all(lo < hi for lo, hi in runs) and all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert tint8.int8_smem(m, k, bn, splits) <= tint8.SMEM_MAX


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("k,n", LM_KN)
def test_int8_plan_fills_the_card(m, k, n):
    """At least one block per SM (132) at every LM shape; the codes head
    (N = 65536) needs no split."""
    bn, splits = tint8.int8_plan(m, k, n)
    assert n // bn * splits >= tint8.SMS
    assert splits == 1 or n // bn < tint8.SMS


class _FakeLib:
    """Records the slots the wrapper packs instead of launching."""

    def __init__(self):
        self.calls = []

    def acestep_qmm_int8(self, slots):
        self.calls.append(struct.unpack(f"<{len(slots) // 8}q", slots))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    from acestep_tpu_torch.ops.cuda import _build
    lib = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    return lib


def _stacked_q8(layers=3, k=1024, n=256):
    g = torch.Generator().manual_seed(0)
    return precast_quant_scales(stack_layers(
        [quantize(torch.randn((k, n), generator=g) * 0.05, "q8_0") for _ in range(layers)]))


def test_int8_wrapper_reads_layer_li_in_place(fake_lib):
    """The slots name layer li's data and scales as base + li layer strides,
    the pointers of the view qt.layer(li), and the plan's tile and split."""
    st = _stacked_q8()
    x = torch.zeros((2, 1024), dtype=torch.bfloat16)
    for li in (0, 1, 2):
        tint8._launch(x, st, li)
        view = st.layer(li)
        slots = fake_lib.calls[-1]
        assert slots[2] == view.data.data_ptr() and slots[3] == view.scales.data_ptr()
        assert slots[:2] == (x.data_ptr(), 0) and slots[5:10] == (2, 256, 1024,
                                                                  *tint8.int8_plan(2, 1024, 256))
    tint8._launch(x.float(), st.layer(1))             # a 2-D weight; f32 x
    assert fake_lib.calls[-1][1] == 1 and fake_lib.calls[-1][2] == st.layer(1).data.data_ptr()


def test_int8_wrapper_raises_before_any_launch(fake_lib):
    """What the kernel cannot take raises in the wrapper before the kernel is
    built or launched."""
    st = _stacked_q8()
    x = torch.zeros((2, 1024), dtype=torch.bfloat16)
    bad = [(torch.zeros((2, 512), dtype=torch.bfloat16), st, 0),          # K mismatch
           (torch.zeros((17, 1024), dtype=torch.bfloat16), st, 0),        # M > 16
           (x, st, None),                                                # stacked needs li
           (x, st.layer(0), 0),                                          # 2-D takes none
           (x, st, 3),                                                   # no layer 3
           (x, stack_layers([quantize(torch.randn((1024, 256)) * 0.05, "q8_0")] * 2), 0),
           (x, precast_quant_scales(quantize(torch.randn((1024, 200)) * 0.05, "q8_0")), None),
           (x, precast_quant_scales(quantize(torch.randn((1024, 256)) * 0.05, "q4_0")), None),
           (x, st.map(lambda a: a.transpose(-1, -2).contiguous().transpose(-1, -2)), 0)]
    for args in bad:
        with pytest.raises((ValueError, IndexError)):
            tint8._launch(*args)
    assert fake_lib.calls == []
