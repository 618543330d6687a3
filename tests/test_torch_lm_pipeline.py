"""Port parity: the LM planner pipeline of acestep_tpu_torch (lm_pipeline.py)
against the JAX package's, on the CPU.

The prompt builders and the CoT parser are held string for string.  The
two-phase generation runs greedy (temperature 0) at the JAX tests' TINY
config (test_lm_pipeline.py:105, f32 weights drawn from a numpy seed) with
the mock byte tokenizer and AUDIO_CODEBOOK_SIZE patched to 500 in both
packages, and is held token for token: CoT text, metadata, every candidate's
codes.  Sampled runs are not compared (the two packages draw different random
numbers); they are held to the duration contract instead.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import lm_pipeline as jlp
from acestep_tpu.models import qwen as jqwen
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import lm_pipeline as tlp
from acestep_tpu_torch import weights
from tests.test_lm_pipeline import TINY, MockTokenizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CODEBOOK = 500


def test_prompt_builders_string_equal():
    cot = "<think>\nbpm: 120\ncaption: soft\n</think>"
    for caption, lyrics in (("calm piano", "hello world"), ("", ""), ("a\nb", "[verse]\nla")):
        for neg in (tlp.DEFAULT_NEGATIVE_PROMPT, "noisy drums", ""):
            for is_neg in (False, True):
                for phase in ("cot", "codes"):
                    assert tlp.build_formatted_prompt(caption, lyrics, is_neg, phase, neg) == \
                        jlp.build_formatted_prompt(caption, lyrics, is_neg, phase, neg)
                assert tlp.build_formatted_prompt_with_cot(caption, lyrics, cot, is_neg, neg) \
                    == jlp.build_formatted_prompt_with_cot(caption, lyrics, cot, is_neg, neg)
    msgs = [{"role": "user", "content": "x"}, {"role": "assistant", "content": "y"}]
    for gen in (True, False):
        assert tlp.apply_chat_template(msgs, gen) == jlp.apply_chat_template(msgs, gen)


PARSE_CASES = [
    "<think>\nbpm: 73\ncaption: A calm piano melody\nduration: 273\ngenres: Chinese folk\n"
    "keyscale: G major\nlanguage: en\ntimesignature: 4\n</think>\n\n"
    "<|audio_code_56535|><|audio_code_62918|>",
    "<think>\ncaption: first line\n  second line\nbpm: 99\n</think>",
    "bpm: 120\ncaption: test\n<|audio_code_5|>",
    "<reasoning>\nbpm: fast\nduration: 30\nunknown: x\n</reasoning>",
    "no metadata at all",
]


@pytest.mark.parametrize("text", PARSE_CASES)
def test_parse_and_codes_equal(text):
    assert tlp.parse_lm_output(text) == jlp.parse_lm_output(text)
    codes = tlp.parse_lm_output(text)[1]
    np.testing.assert_array_equal(tlp.codes_to_indices(codes), jlp.codes_to_indices(codes))
    md = tlp.parse_lm_output(text)[0]
    assert tlp.metadata_to_cot(md) == jlp.metadata_to_cot(md)
    assert tlp.postprocess_caption(" a\n  b \n\n c") == jlp.postprocess_caption(" a\n  b \n\n c")
    idx = [0, 5, 63999]
    assert tlp.indices_to_codes(idx) == jlp.indices_to_codes(idx)
    assert [tlp.code_bucket(n) for n in (1, 64, 65, 602, 5000)] == \
        [jlp.code_bucket(n) for n in (1, 64, 65, 602, 5000)]
    assert [tlp._suffix_bucket(n) for n in (3, 17, 4000)] == \
        [jlp._suffix_bucket(n) for n in (3, 17, 4000)]


# ---------------------------------------------------------------------------
# two-phase generation, greedy, token for token
# ---------------------------------------------------------------------------

GEN_CASES = {
    "no_thinking_batch2": dict(caption="c", lyrics="l", target_duration_s=2.0, thinking=False,
                               user_metadata={"bpm": 100, "duration": 2}, batch_size=2,
                               chunk_size=2),
    "thinking_batch2": dict(caption="warm synth", lyrics="ah ah", target_duration_s=2.0,
                            max_cot_tokens=8, seed=3, batch_size=2, chunk_size=1),
    "cfg": dict(caption="calm piano", lyrics="la la la", target_duration_s=3.0,
                thinking=False, cfg_scale=2.0),
}


def _params():
    rng = np.random.default_rng(0)
    return jqwen.init_params(jax.random.key(0), TINY, dtype=jnp.float32, scale=1.0,
                             sampler=lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))


@pytest.fixture(scope="module")
def pipes():
    p = _params()
    port_cfg = tcfg.QwenConfig(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    return (jlp.LMPipeline(p, TINY, MockTokenizer()),
            tlp.LMPipeline(weights.from_jax_numpy(p), port_cfg, MockTokenizer(), device="cpu"))


@pytest.fixture(scope="module")
def jax_results(pipes):
    mp = pytest.MonkeyPatch()
    mp.setattr(jlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    try:
        return {name: pipes[0].generate_with_stop_condition(temperature=0.0, **kw)
                for name, kw in GEN_CASES.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_greedy_two_phase_identical(pipes, jax_results, case, monkeypatch):
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    port = pipes[1]
    hits = port.prefix_cache.hits
    res = port.generate_with_stop_condition(temperature=0.0, **GEN_CASES[case])
    ref = jax_results[case]
    assert res.cot_text == ref.cot_text
    assert res.metadata == ref.metadata
    assert len(res.candidates) == len(ref.candidates)
    for got, want in zip(res.candidates, ref.candidates):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res.code_indices, ref.code_indices)
    assert res.audio_codes == ref.audio_codes
    n_codes = int(round(GEN_CASES[case]["target_duration_s"] * 5))
    assert all(len(c) == n_codes for c in res.candidates)
    assert ("lm_phase1_time_cost" in res.time_costs) == GEN_CASES[case].get("thinking", True)
    if GEN_CASES[case].get("thinking", True):
        assert port.prefix_cache.hits > hits          # phase 2 reused phase 1's prefill


def test_run_greedy_identical(pipes):
    """``_run``: one batch-1 generation from a prompt string (no prefix cache),
    greedy, with and without the CFG pair, token for token with the JAX one."""
    prompt = tlp.build_formatted_prompt("calm piano", "la la")
    uncond = tlp.build_formatted_prompt("calm piano", "la la", is_negative_prompt=True)
    for cfg_scale in (1.0, 2.0):
        jsp = jlp.SamplingParams(temperature=0.0, max_new_tokens=6, cfg_scale=cfg_scale)
        tsp = tlp.SamplingParams(temperature=0.0, max_new_tokens=6, cfg_scale=cfg_scale)
        ref, n_ref = pipes[0]._run(prompt, jsp, jax.random.key(0), uncond)
        got, n_got = pipes[1]._run(prompt, tsp, None, uncond)
        assert n_got == n_ref
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_sampled_generation_keeps_the_duration_contract(pipes, monkeypatch):
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    kw = dict(target_duration_s=2.0, max_cot_tokens=8, batch_size=3, chunk_size=2)
    a = pipes[1].generate_with_stop_condition("warm synth", "ah", seed=5, **kw)
    b = pipes[1].generate_with_stop_condition("warm synth", "ah", seed=5, **kw)
    assert len(a.candidates) == 3
    for c in a.candidates:
        assert len(c) == 10 and ((c >= 0) & (c < CODEBOOK)).all()
    for x, y in zip(a.candidates, b.candidates):             # seeded: repeatable
        np.testing.assert_array_equal(x, y)
    assert a.cot_text == b.cot_text


def test_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port_cfg = tcfg.QwenConfig(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlp.LMPipeline({}, port_cfg, MockTokenizer())
