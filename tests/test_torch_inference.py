"""Port parity: acestep_tpu_torch.inference (generate_music and the LM-only
flows), serving.launch.build_lm and the SDE sampler against the JAX package,
on the CPU.

The stack is tests/test_inference.py's: its tiny LM config (32 wide, vocab
512) and mock tokenizer, with f32 LM weights from a numpy seed; the DiT and
text encoder are test_torch_pipeline.py's q8_0 models with their kernels
scaled x4, and its SLICE_VAE, so the int16 gate (cosine >= 0.999, SNR >= 26
dB) means what it means there.  The JAX engine takes its XLA matmul path, as
everywhere on the CPU.  Each side gets the same noise: the JAX package's own
draws are passed to the port.  Greedy LM runs are held token for token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import inference as jinf
from acestep_tpu import lm_pipeline as jlp
from acestep_tpu import loader as jloader
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu.serving import launch as jlaunch
from acestep_tpu_torch import inference as tinf
from acestep_tpu_torch import lm_pipeline as tlp
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import sampler as tsampler
from acestep_tpu_torch import weights
from acestep_tpu_torch.serving import launch as tlaunch
from tests.test_inference import TINY_TEXT as LM_CFG
from tests.test_inference import MockTok
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, _quant_policy, jax_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

GATE_COSINE, GATE_SNR_DB = 0.999, 26.0
CODEBOOK = 100          # codes [410, 510) of the 512-piece LM vocabulary
DIM = TINY_DIT.audio_acoustic_hidden_dim


def _lm_params(seed=4):
    rng = np.random.default_rng(seed)
    return jqwen.init_params(jax.random.key(seed), LM_CFG, dtype=jnp.float32, scale=1.0,
                             sampler=lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def stacks():
    dp, tp, vp = jax_params(seed=3)
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    lp = _lm_params()
    jlm = jlp.LMPipeline(lp, LM_CFG, MockTok())
    tlm = tlp.LMPipeline(weights.from_jax_numpy(to_np(lp)), port_cfg(LM_CFG), MockTok(),
                         device="cpu")
    return jeng, teng, jlm, tlm


@pytest.fixture
def xla_qmm(monkeypatch):
    # the JAX engine's q8_0 linears through its XLA path (its Pallas default
    # runs only on a TPU); both codebooks shrunk to fit the tiny vocabulary
    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")
    monkeypatch.setattr(jlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)


def _jax_noise(seed, duration):
    t = tpipeline.bucket_frames(tpipeline.frames_for_duration(duration))
    return torch.from_numpy(np.asarray(jsampler.make_noise([seed], (1, t, DIM))))


def _jax_sde_noise(seed, duration, n_steps=8):
    """The JAX sampler's SDE draws: normal(split(key(seed), n_steps)[i])."""
    t = tpipeline.bucket_frames(tpipeline.frames_for_duration(duration))
    keys = jax.random.split(jax.random.key(seed), n_steps)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.normal(k, (1, t, DIM), jnp.float32)) for k in keys]))


def _gate(ref, got):
    ref, got = np.asarray(ref, np.float64).ravel(), np.asarray(got, np.float64).ravel()
    assert np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def _params(mod, **kw):
    rng = np.random.default_rng(11)
    base = dict(caption="jazz", lyrics="la la", duration=10.0,
                style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
                lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)))
    base.update(kw)
    return mod.GenerationParams(**base)


def test_generate_music_constrained_thinking_equal(stacks, xla_qmm):
    """Thinking with the constrained CoT (the default, device DFA) at
    temperature 0: equal metadata, CoT and codes; the user's bpm forced and
    kept; duration x 5 codes; the int16 audio within the gate."""
    jeng, teng, jlm, tlm = stacks
    kw = dict(thinking=True, bpm=120, lm_temperature=0.0)
    cfg = dict(seeds=[1])
    ref = jinf.generate_music(jeng, jlm, _params(jinf, **kw), jinf.GenerationConfig(**cfg))
    got = tinf.generate_music(teng, tlm, _params(tinf, **kw), tinf.GenerationConfig(**cfg),
                              noise=_jax_noise(1, 10.0))
    assert got.lm_result.cot_route == "device_dfa"
    assert got.lm_result.cot_text == ref.lm_result.cot_text
    assert got.metadata == ref.metadata
    assert got.metadata["bpm"] == 120 and got.metadata["duration"] == 10
    assert "bpm: 120" in got.lm_result.cot_text
    np.testing.assert_array_equal(got.lm_result.code_indices, ref.lm_result.code_indices)
    assert len(got.lm_result.code_indices) == 50                  # 10 s x 5 Hz
    assert got.lm_result.audio_codes == ref.lm_result.audio_codes
    for key in ("lm_phase1_time_cost", "lm_phase2_time_cost", "diffusion_time_cost",
                "total_time_cost"):
        assert key in got.time_costs
    assert got.sample_rate == ref.sample_rate and got.seeds == ref.seeds == [1]
    assert got.pcm16().shape == ref.pcm16().shape
    _gate(ref.audio, got.audio)


def test_generate_music_ranks_candidates_as_jax(stacks, xla_qmm):
    """lm_num_candidates=3: sampled candidates (the port's draws), ranked by
    PMI; the kept one is the JAX package's best on the same candidates."""
    _, teng, jlm, tlm = stacks
    params = _params(tinf, thinking=False, bpm=100, lm_num_candidates=3,
                     lm_codes_temperature=1.0)
    res = tinf.generate_music(teng, tlm, params, tinf.GenerationConfig(seeds=[2]),
                              noise=_jax_noise(2, 10.0))
    cands = res.lm_result.candidates
    assert len(cands) == 3 and "lm_ranking_time_cost" in res.time_costs
    cond = jlm.tok.encode("# Caption\njazz\n\n# Lyric\nla la\n")
    base = jlm.tok.audio_code_base_id
    tok = [list(np.asarray(c) + base) for c in cands]
    from acestep_tpu import scoring as jscoring

    scores = jscoring.calculate_reward_scores(jlm.params, jlm.cfg, cond, tok)
    best = int(np.argmax(scores))
    assert sorted(scores)[-1] - sorted(scores)[-2] > 2e-3 * max(1.0, abs(scores[best]))
    np.testing.assert_array_equal(res.lm_result.code_indices, cands[best])


def test_generate_music_sde_without_lm(stacks, xla_qmm):
    """No LM, SDE sampling with the JAX package's per-step draws passed in."""
    jeng, teng, _, _ = stacks
    kw = dict(thinking=False, infer_method="sde")
    ref = jinf.generate_music(jeng, None, _params(jinf, **kw), jinf.GenerationConfig(seeds=[3]))
    got = tinf.generate_music(teng, None, _params(tinf, **kw), tinf.GenerationConfig(seeds=[3]),
                              noise=_jax_noise(3, 10.0), sde_noise=_jax_sde_noise(3, 10.0))
    assert got.lm_result is None and got.metadata == ref.metadata == {"duration": 10}
    _gate(ref.audio, got.audio)


@pytest.mark.parametrize("method", ["ode", "sde"])
def test_sample_latents_equal(stacks, method):
    """sample_latents, ODE and SDE, on the same inputs and draws: the latents
    within the gate's cosine and SNR."""
    jeng, teng, _, _ = stacks
    rng = np.random.default_rng(6)
    req = dict(duration_s=10.24, style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
               lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)), seeds=[4])
    jreq = jpipeline.GenerationRequest(**req)
    treq = tpipeline.GenerationRequest(**req)
    t = 256
    enc, mask = jeng.build_condition(jreq, 1)
    ctx = jeng.build_context_latents(jreq, 1, t, t)
    noise = np.asarray(jsampler.make_noise([4], (1, t, DIM)))
    schedule = jsampler.get_timestep_schedule(3.0)
    ref = np.asarray(jsampler.sample_latents(
        jeng.dit_params, TINY_DIT, jnp.asarray(noise), ctx, enc, mask, schedule,
        infer_method=method, sde_key=jax.random.key(4)))
    tenc, tmask = teng.build_condition(treq, 1)
    got = tsampler.sample_latents(
        teng.dit_params, teng.dit_cfg, torch.from_numpy(noise), teng.build_context_latents(treq, 1, t),
        tenc, tmask, tsampler.get_timestep_schedule(3.0), infer_method=method,
        sde_noise=_jax_sde_noise(4, 10.24) if method == "sde" else None).numpy()
    _gate(ref, got)
    if method == "sde":
        ode = tsampler.sample_latents(
            teng.dit_params, teng.dit_cfg, torch.from_numpy(noise),
            teng.build_context_latents(treq, 1, t), tenc, tmask, tsampler.get_timestep_schedule(3.0))
        assert eval_metrics.snr_db(got.ravel(), ode.numpy().ravel()) < 20.0   # another function
    with pytest.raises(ValueError, match="infer_method"):
        tsampler.sample_latents(teng.dit_params, teng.dit_cfg, torch.from_numpy(noise),
                                teng.build_context_latents(treq, 1, t), tenc, tmask, schedule,
                                infer_method="euler")


def test_lm_only_flows_equal(stacks, xla_qmm):
    _, _, jlm, tlm = stacks
    for name, arg in (("understand_music", "<|audio_code_1|><|audio_code_2|>"),
                      ("create_sample", "something jazzy"), ("format_sample", "fast edm please")):
        ref = getattr(jinf, name)(jlm, arg, temperature=0.0, max_tokens=16)
        got = getattr(tinf, name)(tlm, arg, temperature=0.0, max_tokens=16)
        assert got == ref, name
        assert got["raw_output"]
    for q in ("codes", ""):
        for neg in (False, True):
            assert tlp.build_understanding_prompt(q, neg) == jlp.build_understanding_prompt(q, neg)
    assert tlp.build_sample_prompt("q") == jlp.build_sample_prompt("q")
    assert tlp.build_sample_prompt("q", "x") == jlp.build_sample_prompt("q", "x")


def test_cover_and_codec_raise(stacks, xla_qmm):
    """Every task, source and reference latents and codec parameters now run
    (their parity: tests/test_torch_{audio_tasks,codec,timbre}.py); without a
    source, cover and repaint give text2music's output bit for bit, and an
    unknown task is text2music, as in the JAX engine.  What raises is what the
    JAX package raises on: a codec tree without its weights (KeyError)."""
    jeng, teng, jlm, tlm = stacks
    noise = _jax_noise(1, 10.0)
    kw = dict(thinking=False, use_cot_metas=False)
    plain = tinf.generate_music(teng, tlm, _params(tinf, **kw), noise=noise)
    for task in ("cover", "repaint", "karaoke"):
        res = tinf.generate_music(teng, tlm, _params(tinf, task_type=task, **kw), noise=noise)
        np.testing.assert_array_equal(res.pcm16(), plain.pcm16())
    for extra in (dict(task_type="cover", src_latents=np.zeros((1, 250, DIM), np.float32)),
                  dict(refer_latents=np.zeros((1, 1, 50, DIM), np.float32))):
        res = tinf.generate_music(teng, tlm, _params(tinf, **kw, **extra), noise=noise)
        assert np.isfinite(res.audio).all() and res.pcm16().shape == plain.pcm16().shape
    for mod, eng, lm in ((jinf, jeng, jlm), (tinf, teng, tlm)):
        with pytest.raises(KeyError):
            mod.generate_music(eng, lm, _params(mod, thinking=False, bpm=100),
                               codec_params={"w": 0})
    assert tinf.GenerationParams().lm_constrained_cot is True


def test_build_lm_from_a_jax_checkpoint(tmp_path):
    """A q8_0 LM written by the JAX package's save_params, its config and a tiny
    WordLevel tokenizer.json: the port's build_lm gives the JAX build_lm's
    greedy tokens; without the files it returns None."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, "dreamy": 1, "synthwave": 2, "la": 3, "#": 4, "Caption": 5,
             "Lyric": 6, "Instruction": 7}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["</think>", "<|im_end|>", "<|audio_code_0|>"])
    tok.save(str(tmp_path / "tokenizer.json"))
    assert tlaunch.build_lm(str(tmp_path), device="cpu") is None       # no lm files yet
    assert tlaunch.build_lm(None) is None
    params = quantize_tree_jax(_lm_params(8), "q8_0", policy=_quant_policy)
    jloader.save_params(str(tmp_path / "lm"), params)
    with open(tmp_path / "lm.config.json", "w") as f:
        json.dump({f: getattr(LM_CFG, f) for f in LM_CFG.__dataclass_fields__}, f)

    jlm = jlaunch.build_lm(str(tmp_path))
    tlm = tlaunch.build_lm(str(tmp_path), device="cpu")
    assert isinstance(tlm.tok, tlp.TokenizerJsonAdapter)
    for attr in ("eos_token_id", "think_end_id", "audio_code_base_id"):
        assert getattr(tlm.tok, attr) == getattr(jlm.tok, attr)
    assert tlm.tok.encode("dreamy synthwave la") == [1, 2, 3]
    prompt = tlp.build_formatted_prompt("dreamy synthwave", "la la")
    ref, n_ref = jlm._run(prompt, jlp.SamplingParams(temperature=0.0, max_new_tokens=8),
                          jax.random.key(0))
    got, n_got = tlm._run(prompt, tlp.SamplingParams(temperature=0.0, max_new_tokens=8), None)
    assert n_got == n_ref == 8
    np.testing.assert_array_equal(got, np.asarray(ref))
