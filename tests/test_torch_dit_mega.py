"""Port parity of the DiT Euler-step megakernel (kernel row 12,
acestep_tpu_torch/ops/cuda/dit_mega.py), of ``dit.forward(dit_mega=True)`` and
of the whole text2music slice with both opt-in switches, against the JAX
package, on the CPU.

The JAX side runs ``dit_layers_mega`` in Pallas interpret mode (its own CPU
route) with ``ACESTEP_TPU_DIT_MEGA=1``, at the conformant tiny config of
tests/test_dit_mega.py: 256 wide, intermediate 512, 2 query / 1 kv head of
dim 128, sliding window 4 (so the band masks at T = 16 tokens, which it cannot
at full width, where the window is 128 and T = 128), 2 layers.

Tolerances: the JAX megakernel test's (test_dit_mega.py:92-93), cosine >=
0.99999 and atol 5e-3 + rtol 5e-2.  Measured here: the plain version
against the interpret kernel, max abs error 5.0e-4 at a peak of 3.7 (1 -
cosine 4e-9); the forward, 7.1e-5 at a peak of 1.05; dropping the band
moves the kernel's output by 0.115.  The whole slice (8 Euler steps): the Q8_0 gate of
docs/BENCHMARK.md:25-29 on the int16 waveform (cosine >= 0.999, SNR >= 26 dB,
acestep_tpu.eval_metrics) and the latents at cosine >= 0.9999.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import acestep_tpu.ops.pallas.qmm as jqmm
from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.ops.pallas import dit_mega as jdm
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.ops import rope_cos_sin
from acestep_tpu_torch.ops.cuda import dit_mega as tdm
from acestep_tpu_torch.ops.cuda import qmm_int8 as tint8
from acestep_tpu_torch.quant import QuantTensor
from tests.test_dit_mega import CFG, LC, T_FRAMES, _fwd, _inputs, _params
from tests.test_pipeline import TINY_TEXT
from tests.test_torch_models import SLICE_VAE, _scale_kernels, _vae_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

COS_MIN = 0.99999
ATOL, RTOL = 5e-3, 5e-2
GATE_COSINE, GATE_SNR_DB, LATENT_COS = 0.999, 26.0, 0.9999
T_TOK = T_FRAMES // 2


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert _cos(got, ref) >= COS_MIN
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def setup():
    params = _params()
    hs, ctx, enc = _inputs()
    kv = jdit.compute_all_cross_kv(params, CFG, enc)
    tparams = weights.from_jax_numpy(to_np(params))
    return params, tparams, hs, ctx, kv


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the port's calls of the two kernels' plain versions."""
    calls = {"mega": 0, "int8": 0}
    real_mega, real_int8 = tdm.dit_layers_mega_plain, tint8.qmm_int8_act_plain

    def mega(*a, **kw):
        calls["mega"] += 1
        return real_mega(*a, **kw)

    def int8(*a, **kw):
        calls["int8"] += 1
        return real_int8(*a, **kw)

    monkeypatch.setattr(tdm, "dit_layers_mega_plain", mega)
    monkeypatch.setattr(tint8, "qmm_int8_act_plain", int8)
    return calls


def _port_kv(kv):
    """JAX (k_stack, v_stack) [L, B, Hkv, Lc, D] -> the port's per-layer list."""
    k, v = (torch.from_numpy(np.asarray(a, np.float32)) for a in kv)
    return [(k[i], v[i]) for i in range(k.shape[0])]


def _fake_layers(cfg, n_layers):
    """Stacked q8_0 weights of ``cfg``'s shapes with f32 scales, as zero-stride
    views (the gate reads shapes and types only)."""
    h, qdim = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
    kvdim, inter = cfg.num_key_value_heads * cfg.head_dim, cfg.intermediate_size

    def qt(k, n):
        return QuantTensor("q8_0", (k, n),
                           data=torch.zeros(1, 1, 1, dtype=torch.int8).expand(n_layers, k, n),
                           scales=torch.zeros(1, 1, 1).expand(n_layers, k // 32, n))

    return {"self_attn": {"qkv_proj": {"kernel": qt(h, qdim + 2 * kvdim)},
                          "o_proj": {"kernel": qt(qdim, h)}},
            "cross_attn": {"q_proj": {"kernel": qt(h, qdim)}, "o_proj": {"kernel": qt(qdim, h)}},
            "mlp": {"gateup_proj": {"kernel": qt(h, 2 * inter)},
                    "down_proj": {"kernel": qt(inter, h)}}}


def test_gate_matches_jax(setup):
    params, tparams, *_ = setup
    pcfg = port_cfg(CFG)
    for b, t, lc in ((1, T_TOK, LC), (1, 8, 40), (2, T_TOK, LC), (1, 12, LC), (1, 1 << 20, LC)):
        assert tdm.supported(tparams["layers"], pcfg, b, t, lc) == \
            jdm.supported(params["layers"], CFG, b, t, lc), (b, t, lc)
    assert not tdm.supported(tparams["layers"], pcfg, 2, T_TOK, LC)
    # an unfused, f16-scaled or bf16 decoder declines on both sides
    unfused = dict(tparams["layers"], mlp={"down_proj": tparams["layers"]["mlp"]["down_proj"]})
    assert not tdm.supported(unfused, pcfg, 1, T_TOK, LC)
    # full width: the JAX VMEM estimate admits T = 128 (10.24 s) and declines
    # T = 256 (20.48 s); the port's gate admits both
    full = DiTConfig()
    for t, jax_ok in ((128, True), (256, False)):
        assert (jdm._vmem_estimate(full, t, 320) <= jdm.VMEM_BUDGET) == jax_ok
        assert tdm.supported(_fake_layers(port_cfg(full), 24), port_cfg(full), 1, t, 320)


@pytest.mark.parametrize("padded", [False, True])
def test_plain_matches_interpret_kernel(setup, padded):
    """Same inputs through the JAX kernel (interpret mode) and the port's
    plain version, with and without padded condition tokens."""
    params, tparams, hs, ctx, kv = setup
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, T_TOK, CFG.hidden_size)).astype(np.float32)
    tproj = (rng.standard_normal((1, 6, CFG.hidden_size)) * 0.3).astype(np.float32)
    cos, sin = rope_cos_sin(torch.arange(T_TOK), CFG.head_dim, base=CFG.rope_theta)
    encm = np.zeros((1, LC), np.float32)
    if padded:
        encm[:, 10:] = -1e30
    flags = [lt == "sliding_attention" for lt in CFG.layer_types]
    ref = np.asarray(jdm.dit_layers_mega(
        params["layers"], CFG, jnp.asarray(x), kv[0], kv[1], jnp.asarray(tproj),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()), flags, jnp.asarray(encm),
        interpret=True))
    tk, tv = (torch.from_numpy(np.asarray(a, np.float32)) for a in kv)
    got = tdm.dit_layers_mega(tparams["layers"], port_cfg(CFG), torch.from_numpy(x), tk, tv,
                              torch.from_numpy(tproj), cos, sin, flags, torch.from_numpy(encm))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("padded", [False, True])
def test_forward_matches_jax(setup, monkeypatch, plain_calls, padded):
    """dit.forward(dit_mega=True) against the JAX forward under
    ACESTEP_TPU_DIT_MEGA=1 at (t, r) = (0.4, 0.3)."""
    params, tparams, hs, ctx, kv = setup
    enc_mask = None
    if padded:
        enc_mask = np.concatenate([np.ones((1, 10)), np.zeros((1, LC - 10))], 1).astype(
            np.float32)
    monkeypatch.setenv("ACESTEP_TPU_DIT_MEGA", "1")
    ref = np.asarray(_fwd(params, hs, ctx, kv, t=0.4, r=0.3,
                          enc_mask=None if enc_mask is None else jnp.asarray(enc_mask)))
    got = tdit.forward(tparams, port_cfg(CFG), torch.from_numpy(np.asarray(hs)),
                       torch.tensor([0.4]), torch.tensor([0.3]),
                       torch.from_numpy(np.asarray(ctx)), _port_kv(kv),
                       encoder_attn_mask=None if enc_mask is None else torch.from_numpy(enc_mask),
                       dit_mega=True)
    assert plain_calls["mega"] == 1
    _close(got.numpy(), ref)


@pytest.mark.parametrize("case", ["batch 2", "self-attention mask"])
def test_outside_the_gate_takes_the_layer_path(setup, plain_calls, case):
    _, tparams, _, _, _ = setup
    b = 2 if case == "batch 2" else 1
    hs, ctx, enc = (torch.from_numpy(np.asarray(a)) for a in _inputs(b=b, seed=3))
    kv = tdit.compute_all_cross_kv(tparams, port_cfg(CFG), enc)
    mask = None
    if case == "self-attention mask":
        mask = (torch.arange(T_FRAMES)[None, :] < T_FRAMES - 6).to(torch.int32)
    t = torch.full((b,), 0.4)
    outs = [tdit.forward(tparams, port_cfg(CFG), hs, t, t, ctx, kv, attn_mask=mask,
                         dit_mega=mega) for mega in (True, False)]
    assert plain_calls["mega"] == 0
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the whole slice: both switches, 10.24 s (frames fill their bucket)
# ---------------------------------------------------------------------------

SLICE_DIT = dataclasses.replace(CFG, text_hidden_dim=TINY_TEXT.hidden_size)
KERNEL_GAIN = 2.0      # the 256-wide slices' gain (test_torch_pipeline_q4.py)
N_STEPS = 8            # the turbo schedule at shift 3


def _slice_params(seed=3):
    import jax

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    rng = np.random.default_rng(seed)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    def every_kernel(path, a):
        return getattr(a, "ndim", 0) == 2 and path.endswith("kernel")

    dp = quantize_tree_jax(_scale_kernels(jdit.init_params(k1, SLICE_DIT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=every_kernel)
    tp = quantize_tree_jax(_scale_kernels(jqwen.init_params(k3, TINY_TEXT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=every_kernel)
    return dp, tp, _vae_params(k2, SLICE_VAE, rng)


def _slice_request(cls):
    rng = np.random.default_rng(5)
    return cls(duration_s=10.24, seeds=[1],
               style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
               lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)))


def test_whole_slice_with_both_switches(monkeypatch, plain_calls):
    dp, tp, vp = _slice_params()
    jcalls = {"mega": 0, "int8": 0}
    real_mega, real_int8, real_nd = jdm.dit_layers_mega, jqmm.qmm_int8_act, jqmm.qmm_pallas_nd
    real_st = jqmm.qmm_pallas_stacked_nd

    def mega(*a, **kw):
        jcalls["mega"] += 1
        return real_mega(*a, **kw)

    def int8(*a, **kw):
        jcalls["int8"] += 1
        return real_int8(*a, **kw)

    for name, value in (("ACESTEP_TPU_QMM_BACKEND", "pallas"), ("ACESTEP_TPU_INT8_ACT", "1"),
                        ("ACESTEP_TPU_DIT_MEGA", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(jdm, "dit_layers_mega", mega)
    monkeypatch.setattr(jqmm, "qmm_int8_act", int8)
    monkeypatch.setattr(jqmm, "qmm_pallas_nd", lambda x, qt, **kw: real_nd(x, qt, interpret=True))
    monkeypatch.setattr(jqmm, "qmm_pallas_stacked_nd",
                        lambda x, qt, li, **kw: real_st(x, qt, li, interpret=True))
    jeng = jpipeline.AceStepEngine(dp, SLICE_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    jres = jeng.generate(_slice_request(jpipeline.GenerationRequest))
    assert jcalls["mega"] > 0 and jcalls["int8"] > 0     # traced into the JAX step

    t = jpipeline.bucket_frames(jpipeline.frames_for_duration(10.24))
    assert t == jpipeline.frames_for_duration(10.24) == 256
    noise = np.asarray(jsampler.make_noise([1], (1, t, SLICE_DIT.audio_acoustic_hidden_dim)))
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(SLICE_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu",
        dit_mega=True, int8_act=True)
    res = teng.generate(_slice_request(tpipeline.GenerationRequest),
                        noise=torch.from_numpy(noise))
    # every step through the megakernel and the six timestep linears through row 6
    assert plain_calls["mega"] == N_STEPS
    assert plain_calls["int8"] == 6 * N_STEPS

    assert res.audio_i16.shape == jres.audio_i16.shape
    assert _cos(res.latents, np.asarray(jres.latents)) >= LATENT_COS
    ref, got = jres.audio.astype(np.float32), res.audio
    assert np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)
