"""Port parity of the audio-in tasks (repaint, cover, extract, lego,
complete) against the JAX package, on the CPU: the context latents of every
task, the VAE's posterior draw, the source / reference encoders and whole
requests through ``AceStepEngine.generate``.

The stack is test_torch_pipeline.py's: q8_0 tiny DiT and text encoder
(kernels x4), SLICE_VAE, the JAX engine on its XLA matmul path, the JAX
package's noise passed to the port.  Tolerances: the chunk mask exactly; the
f32 VAE (silence and source latents, the posterior draw) within 1e-4 of the
peak; whole requests at the int16 gate of test_torch_pipeline.py (cosine >=
0.999, SNR >= 26 dB).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.models import vae as jvae
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import vae as tvae
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import F32_REL_MAX, SLICE_VAE, jax_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

GATE_COSINE, GATE_SNR_DB = 0.999, 26.0
DIM = TINY_DIT.audio_acoustic_hidden_dim
HOP = SLICE_VAE.hop_length
T_VALID, T = 250, 256                      # 10 s in its bucket


@pytest.fixture(scope="module")
def stacks():
    dp, tp, vp = jax_params(seed=3, vae_affine_scale=0.1)
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    return jeng, teng, vp


@pytest.fixture
def xla_qmm(monkeypatch):
    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")


def _f32_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_REL_MAX * np.abs(ref).max())


def _src(seed=0):
    return np.random.default_rng(seed).standard_normal((1, T_VALID, DIM)).astype(np.float32)


def _request(cls, **kw):
    rng = np.random.default_rng(11)
    base = dict(duration_s=10.0, style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
                lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)), seeds=[1])
    base.update(kw)
    return cls(**base)


CONTEXT_CASES = {
    "text2music": dict(task="text2music"),
    "repaint": dict(task="repaint", repaint_start_s=2.0, repaint_end_s=6.5),
    "repaint to the end": dict(task="repaint", repaint_start_s=3.3, repaint_end_s=-1.0),
    "cover": dict(task="cover"),
    "extract": dict(task="extract", track_name="drums"),
    "lego with span": dict(task="lego", repaint_start_s=1.0, repaint_end_s=4.0,
                           track_name="bass"),
    "lego without span": dict(task="lego", track_name="bass"),
    "complete": dict(task="complete", complete_track_classes=["drums"]),
}


@pytest.mark.parametrize("case", list(CONTEXT_CASES))
def test_context_latents_match_jax(stacks, case):
    """[src | chunk mask]: the mask exact, the src channels at the f32 bound;
    a repaint span holds the silence latents, the rest the source (which is
    zero-padded from 250 to the 256-frame bucket)."""
    jeng, teng, _ = stacks
    kw = dict(CONTEXT_CASES[case], src_latents=_src())
    ref = np.asarray(jeng.build_context_latents(jpipeline.GenerationRequest(**kw), 1, T,
                                                T_VALID))
    got = teng.build_context_latents(tpipeline.GenerationRequest(**kw), 1, T, T_VALID).numpy()
    assert got.shape == ref.shape == (1, T, TINY_DIT.context_dim)
    np.testing.assert_array_equal(got[..., DIM:], ref[..., DIM:])
    _f32_close(got[..., :DIM], ref[..., :DIM])
    sil = teng._silence_frames(T)[0].numpy()
    span = got[0, :, DIM] == 1
    if case in ("repaint", "repaint to the end", "lego with span"):
        assert 0 < span.sum() < T_VALID
        np.testing.assert_array_equal(got[0, span, :DIM], sil[span])
        keep = ~span[:T_VALID]
        np.testing.assert_array_equal(got[0, :T_VALID][keep, :DIM], _src()[0][keep])
    elif case != "text2music":
        assert span.all()
        np.testing.assert_array_equal(got[0, :T_VALID, :DIM], _src()[0])
        assert not got[0, T_VALID:, :DIM].any()


def test_repaint_span_frames():
    """``int(s * 25)`` floors, ``end`` < 0 runs to the valid end, and the span
    stops at the valid frames."""
    eng = tpipeline.AceStepEngine.__new__(tpipeline.AceStepEngine)
    eng.dit_cfg, eng.device = port_cfg(TINY_DIT), torch.device("cpu")
    eng._silence_frames = lambda t: torch.full((1, t, DIM), 7.0)
    for start, end, lo, hi in ((2.0, 6.5, 50, 162), (2.03, 6.07, 50, 151), (3.3, -1.0, 82, 240),
                               (0.0, 20.0, 0, 240)):
        req = tpipeline.GenerationRequest(task="repaint", src_latents=_src(),
                                          repaint_start_s=start, repaint_end_s=end)
        mask = eng.build_context_latents(req, 1, T, 240)[0, :, DIM].numpy()
        np.testing.assert_array_equal(np.flatnonzero(mask), np.arange(lo, hi))


def test_encode_and_sample_matches_jax(stacks):
    _, _, vp = stacks
    rng = np.random.default_rng(4)
    audio = rng.standard_normal((2, 20 * HOP, 2)).astype(np.float32) * 0.3
    key = jax.random.key(7)
    ref = np.asarray(jvae.encode_and_sample(vp, SLICE_VAE, jnp.asarray(audio), key))
    draw = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    tvp = weights.from_jax_numpy(to_np(vp))
    got = tvae.encode_and_sample(tvp, port_cfg(SLICE_VAE), torch.from_numpy(audio),
                                 torch.from_numpy(draw)).numpy()
    _f32_close(got, ref)
    mean = tvae.encode(tvp, port_cfg(SLICE_VAE), torch.from_numpy(audio)).numpy()
    assert np.abs(got - mean).max() > 1e-3          # the draw is taken


def test_encode_src_audio_matches_jax(stacks):
    """A mono waveform (repeated to stereo) of 300.5 frames: 300 frames in
    128-frame windows of 32 overlap."""
    jeng, teng, _ = stacks
    mono = np.random.default_rng(5).standard_normal(300 * HOP + HOP // 2).astype(np.float32)
    ref = jeng.encode_src_audio(mono * 0.3)
    got = teng.encode_src_audio(mono * 0.3)
    assert got.shape == ref.shape == (1, 300, DIM) and got.dtype == np.float32
    _f32_close(got, ref)
    stereo = teng.encode_src_audio(np.repeat(mono[:, None] * 0.3, 2, axis=1))
    np.testing.assert_array_equal(got, stereo)


def test_encode_refer_audio_matches_jax(stacks):
    """Two clips: 800 frames mono (cut to 750) and 200 frames stereo (zero-
    padded to the longer)."""
    jeng, teng, _ = stacks
    rng = np.random.default_rng(6)
    clips = [rng.standard_normal(800 * HOP).astype(np.float32) * 0.3,
             rng.standard_normal((200 * HOP, 2)).astype(np.float32) * 0.3]
    ref = jeng.encode_refer_audio(clips)
    got = teng.encode_refer_audio(clips)
    assert got.shape == ref.shape == (1, 2, 750, DIM)
    _f32_close(got, ref)
    assert not got[0, 1, 200:].any() and got[0, 1, :200].any()
    assert teng.encode_refer_audio(clips[1:], max_frames=100).shape == (1, 1, 100, DIM)


def _jax_noise(seed):
    return np.asarray(jsampler.make_noise([seed], (1, T, DIM)))


def _gate(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    assert np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def _refer():
    return np.random.default_rng(8).standard_normal((1, 2, 60, DIM)).astype(np.float32)


GENERATE_CASES = {
    "repaint": dict(task="repaint", repaint_start_s=2.0, repaint_end_s=6.0),
    "cover 0.5 with refer": dict(task="cover", audio_cover_strength=0.5, refer=True),
    "cover 1.0 with refer": dict(task="cover", audio_cover_strength=1.0, refer=True),
    "extract": dict(task="extract", track_name="vocals"),
    "lego with span": dict(task="lego", repaint_start_s=3.0, repaint_end_s=7.0,
                           track_name="guitar"),
    "complete": dict(task="complete", complete_track_classes=["bass", "drums"]),
}


@pytest.mark.parametrize("case", list(GENERATE_CASES))
def test_generate_matches_jax(stacks, xla_qmm, case):
    jeng, teng, _ = stacks
    kw = dict(GENERATE_CASES[case], src_latents=_src(1))
    if kw.pop("refer", False):
        kw["refer_latents"] = _refer()
    ref = jeng.generate(_request(jpipeline.GenerationRequest, **kw))
    got = teng.generate(_request(tpipeline.GenerationRequest, **kw),
                        noise=torch.from_numpy(_jax_noise(1)))
    assert got.audio_i16.shape == np.asarray(ref.audio_i16).shape
    _gate(ref.audio, got.audio)


def test_cover_strength_one_is_plain_cover(stacks):
    """Strength 1.0 takes no switch: equal to the default cover bit for bit
    (tests/test_pipeline.py:153); strength 0.5 switches after 4 of 8 steps."""
    _, teng, _ = stacks
    kw = dict(task="cover", src_latents=_src(2), refer_latents=_refer())
    noise = torch.from_numpy(_jax_noise(2))
    plain = teng.generate(_request(tpipeline.GenerationRequest, **kw), noise=noise)
    one = teng.generate(_request(tpipeline.GenerationRequest, audio_cover_strength=1.0, **kw),
                        noise=noise)
    np.testing.assert_array_equal(one.latents, plain.latents)
    req = _request(tpipeline.GenerationRequest, audio_cover_strength=0.5, **kw)
    sw = teng.cover_switch(req, 1, T, T_VALID, 8, *teng.build_condition(req, 1))
    assert sw["cover_steps"] == 4
    # the non-cover condition masks the two timbre tokens, the context is silence
    assert int(sw["encoder_attn_mask_non_cover"].sum()) == 20 + 40
    assert not sw["context_latents_non_cover"][0, :, :DIM].sub(
        teng._silence_frames(T)[0]).any()
    half = teng.generate(req, noise=noise)
    assert np.abs(half.latents - plain.latents).max() > 1e-4
    assert teng.cover_switch(dataclasses.replace(req, task="repaint"), 1, T, T_VALID, 8,
                             None, None) == {}


def test_cover_switch_on_the_megakernel_path(monkeypatch):
    """With ``dit_mega`` (a conformant tiny DiT, every kernel q8_0, 10.24 s so
    no frame mask) the cover switch hands the megakernel the cover K/V stack
    for 4 steps, then the non-cover one; the latents as the layer path's
    (cosine >= 0.9999, tests/test_torch_dit_mega.py's latent bound)."""
    from acestep_tpu_torch.ops.cuda import dit_mega as tdm
    from tests.test_dit_mega import CFG
    from tests.test_dit_mega import _params as mega_params

    _, tp, vp = jax_params(seed=4)
    parts = (weights.from_jax_numpy(to_np(mega_params())), port_cfg(CFG),
             weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
             weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT))
    mega = tpipeline.AceStepEngine(*parts, device="cpu", dit_mega=True)
    layers = tpipeline.AceStepEngine(*parts, device="cpu")
    stacks = []
    orig = tdm.dit_layers_mega

    def spy(layers_, cfg, x, k_stack, *a, **kw):
        stacks.append(k_stack)
        return orig(layers_, cfg, x, k_stack, *a, **kw)

    monkeypatch.setattr(tdm, "dit_layers_mega", spy)
    req = _request(tpipeline.GenerationRequest, duration_s=10.24, task="cover",
                   src_latents=_src(3), refer_latents=_refer(), audio_cover_strength=0.5)
    noise = torch.from_numpy(_jax_noise(3))
    got = mega.generate(req, noise=noise).latents
    assert len(stacks) == 8
    assert all(s is stacks[0] for s in stacks[:4]) and all(s is stacks[4] for s in stacks[4:])
    assert not torch.equal(stacks[0], stacks[4])
    ref = layers.generate(req, noise=noise).latents
    cos = float(ref.ravel() @ got.ravel() / (np.linalg.norm(ref) * np.linalg.norm(got)))
    assert cos >= 0.9999, cos
