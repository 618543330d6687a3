"""Port parity of the base model's classifier-free guidance
(acestep_tpu_torch.sampler.get_base_timestep_schedule / sample_latents_cfg and
the CFG branch of AceStepEngine.generate) against the JAX package, on the CPU.

The stack is test_torch_pipeline.py's (q8_0 tiny DiT, kernels x4); both
samplers get the same numpy noise, and the SDE form the JAX package's own
per-step draws.  Tolerance: the latents (and the int16 waveform of the whole
request) at the gate of test_torch_pipeline.py, cosine >= 0.999 and SNR >=
26 dB.  The schedule is compared as floats, exactly.

ADG renormalises the guidance delta to |v_c|.  With the neutral uncond (the
same condition, masked out) the delta of the tiny random model is a small
difference of two bf16 velocities, and renormalising it magnifies their
rounding: at guidance 7 the JAX package's own eager and jitted runs part by
22.8 dB (cosine 0.9974), as far as the port parts from them (22.3 dB).  So the
ADG cases here take an explicit 5-token uncond, whose delta is of the
velocities' size (the port then within 36 dB of the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import sampler as tsampler
from acestep_tpu_torch import weights
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, jax_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

GATE_COSINE, GATE_SNR_DB = 0.999, 26.0
DIM = TINY_DIT.audio_acoustic_hidden_dim
T = 256
STEPS, SHIFT = 6, 3.0


@pytest.fixture(scope="module")
def stacks():
    dp, tp, vp = jax_params(seed=3)
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    return jeng, teng


def _gate(ref, got):
    ref = np.asarray(ref, np.float64).ravel()
    got = np.asarray(got, np.float64).ravel()
    assert np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def _kw(**extra):
    rng = np.random.default_rng(21)
    kw = dict(duration_s=10.24, style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
              lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)), seeds=[3])
    kw.update(extra)
    return kw


@pytest.mark.parametrize("steps,shift", [(8, 1.0), (32, 3.0), (50, 2.5), (1, 3.0)])
def test_base_schedule_equal(steps, shift):
    assert tsampler.get_base_timestep_schedule(steps, shift) == \
        jsampler.get_base_timestep_schedule(steps, shift)


CASES = {
    "plain": dict(guidance_scale=7.0),
    "adg": dict(guidance_scale=7.0, use_adg=True, uncond=5),
    "interval": dict(guidance_scale=7.0, cfg_interval_start=0.1, cfg_interval_end=0.9),
    "short uncond": dict(guidance_scale=4.0, uncond=5),
    "sde": dict(guidance_scale=5.0, use_adg=True, uncond=5, infer_method="sde"),
}


def _conditions(eng, mod, uncond_len):
    rng = np.random.default_rng(22)
    req = mod.GenerationRequest(**_kw())
    enc, mask = eng.build_condition(req, 1)
    if not uncond_len:
        return enc, mask, enc, (jnp.zeros_like(mask) if mod is jpipeline
                                else torch.zeros_like(mask))
    ureq = mod.GenerationRequest(style_token_ids=rng.integers(0, TINY_TEXT.vocab_size,
                                                              (1, uncond_len)))
    return (enc, mask) + tuple(eng.build_condition(ureq, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_sample_latents_cfg_matches_jax(stacks, case):
    """The CFG loop on the same conditions (built by each engine), noise and
    SDE draws: plain, ADG, the [0.1, 0.9] interval, an uncond of 5 style
    tokens (32-token bucket) padded to the cond's 96, and SDE with ADG; the
    last three with that uncond, the others with the neutral one."""
    jeng, teng = stacks
    kw = dict(CASES[case])
    uncond = kw.pop("uncond", 0)
    method = kw.get("infer_method", "ode")
    schedule = jsampler.get_base_timestep_schedule(STEPS, SHIFT)
    noise = np.asarray(jsampler.make_noise([3], (1, T, DIM)))
    jc = _conditions(jeng, jpipeline, uncond)
    tc = _conditions(teng, tpipeline, uncond)
    assert tc[2].shape[1] < tc[0].shape[1] if uncond else True
    req = jpipeline.GenerationRequest(**_kw())
    ctx = jeng.build_context_latents(req, 1, T, T)
    key = jax.random.key(3)
    ref = np.asarray(jsampler.sample_latents_cfg(
        jeng.dit_params, TINY_DIT, jnp.asarray(noise), ctx, *jc, schedule, sde_key=key, **kw))
    sde = None
    if method == "sde":
        sde = torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (1, T, DIM)))
                                         for k in jax.random.split(key, STEPS)]))
    got = tsampler.sample_latents_cfg(
        teng.dit_params, teng.dit_cfg, torch.from_numpy(noise),
        teng.build_context_latents(tpipeline.GenerationRequest(**_kw()), 1, T, T), *tc,
        tsampler.get_base_timestep_schedule(STEPS, SHIFT), sde_noise=sde, **kw).numpy()
    _gate(ref, got)
    if case == "plain":       # guidance moves the result: the cond velocity alone differs
        cond_only = tsampler.sample_latents_cfg(
            teng.dit_params, teng.dit_cfg, torch.from_numpy(noise),
            teng.build_context_latents(tpipeline.GenerationRequest(**_kw()), 1, T, T), *tc,
            tsampler.get_base_timestep_schedule(STEPS, SHIFT), guidance_scale=7.0,
            cfg_interval_start=2.0).numpy()
        assert eval_metrics.snr_db(got.ravel(), cond_only.ravel()) < 20.0


def test_generate_cfg_matches_jax(stacks, monkeypatch):
    """The engine's CFG branch (interval, the uncond from 5 style tokens, 6
    steps at shift 3, 10 s in its 256-frame bucket, so with the frame mask)
    against the JAX engine: the latents at the gate (38 dB).  Guided latents
    run ~1.5x larger than turbo ones, and the random tiny VAE magnifies their
    difference to ~20 dB in the waveform, so the audio is held to its shape."""
    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")
    jeng, teng = stacks
    kw = _kw(duration_s=10.0, guidance_scale=6.0, infer_steps=STEPS,
             cfg_interval_start=0.05, cfg_interval_end=0.95,
             uncond_style_token_ids=np.random.default_rng(23).integers(0, 256, (1, 5)))
    ref = jeng.generate(jpipeline.GenerationRequest(**kw))
    got = teng.generate(tpipeline.GenerationRequest(**kw), noise=torch.from_numpy(
        np.asarray(jsampler.make_noise([3], (1, T, DIM)))))
    assert got.time_costs["diffusion_per_step_time_cost"] * STEPS == pytest.approx(
        got.time_costs["diffusion_time_cost"])
    _gate(ref.latents, got.latents)
    assert got.audio_i16.shape == np.asarray(ref.audio_i16).shape
    assert got.audio_lengths == ref.audio_lengths


def test_guidance_one_takes_the_turbo_loop(stacks, monkeypatch):
    """guidance_scale 1.0: the turbo loop and schedule, whatever infer_steps
    and the CFG fields say; the CFG sampler is not called."""
    _, teng = stacks
    noise = torch.from_numpy(np.asarray(jsampler.make_noise([3], (1, T, DIM))))
    turbo = teng.generate(tpipeline.GenerationRequest(**_kw()), noise=noise)

    def refuse(*a, **k):
        raise AssertionError("the CFG loop ran at guidance_scale 1.0")

    monkeypatch.setattr(tsampler, "sample_latents_cfg", refuse)
    one = teng.generate(tpipeline.GenerationRequest(**_kw(
        guidance_scale=1.0, infer_steps=30, use_adg=True, cfg_interval_start=0.5)), noise=noise)
    np.testing.assert_array_equal(one.latents, turbo.latents)
    assert one.time_costs["diffusion_per_step_time_cost"] * 8 == pytest.approx(
        one.time_costs["diffusion_time_cost"])
