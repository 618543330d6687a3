"""Port parity: the constrained CoT of acestep_tpu_torch (serving.lm's
host-stepped FSM and device DFA decode, and LMPipeline's constrained phase 1)
against the JAX package's, on the CPU.

The tiny LM of tests/test_device_fsm.py (f32, 64 wide, 2 layers) reaches the
port through ``weights.from_jax_numpy``; the vocabulary is that file's VOCAB,
the caption budget 24 chars.  Greedy runs are held token for token and text
for text; a sampled run (the packages draw different random numbers) is held
to the grammar: it replays valid through MetadataFSM and ends the block.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from acestep_tpu import constrained as JC
from acestep_tpu import lm_pipeline as jlp
from acestep_tpu.serving import lm as jlm
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import constrained as TC
from acestep_tpu_torch import lm_pipeline as tlp
from acestep_tpu_torch import weights
from acestep_tpu_torch.serving import lm as tlm
from tests.test_device_fsm import VOCAB, _lm, _Tok
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PROMPT = [5, 9, 2, 14]
CODEBOOK = 50          # codes [100, 150) of the 160-piece model vocabulary


@pytest.fixture(scope="module")
def models():
    params, cfg = _lm()
    port_params = weights.from_jax_numpy(jax.tree_util.tree_map(np.asarray, params))
    port_cfg = tcfg.QwenConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return params, cfg, port_params, port_cfg


@pytest.mark.parametrize("user_metadata", [{}, {"bpm": 95}], ids=["none", "bpm"])
def test_greedy_host_and_device_equal_jax(models, user_metadata):
    params, cfg, pp, pcfg = models
    jcfg = JC.FSMConfig(max_caption_chars=24)
    ref_ids, ref_text = jlm.generate_with_fsm(
        params, cfg, PROMPT, JC.MetadataFSM(jcfg, user_metadata=user_metadata), VOCAB,
        jax.random.key(0), temperature=0.0, max_new_tokens=192)

    fcfg = TC.FSMConfig(max_caption_chars=24)
    fsm = TC.MetadataFSM(fcfg, user_metadata=user_metadata)
    host_ids, host_text = tlm.generate_with_fsm(pp, pcfg, PROMPT, fsm, VOCAB, None,
                                                temperature=0.0, max_new_tokens=192)
    assert fsm.done
    assert host_ids == ref_ids and host_text == ref_text

    dfa = TC.compile_dfa(VOCAB, cfg=fcfg, user_metadata=user_metadata)
    for check_every in (16, 1):
        dev_ids, dev_text = tlm.generate_with_fsm_device(
            pp, pcfg, PROMPT, dfa, VOCAB, None, temperature=0.0, max_new_tokens=192,
            check_every=check_every)
        assert dev_ids == host_ids and dev_text == host_text
    jdfa = JC.compile_dfa(VOCAB, cfg=jcfg, user_metadata=user_metadata)
    jdev_ids, jdev_text = jlm.generate_with_fsm_device(
        params, cfg, PROMPT, jdfa, VOCAB, jax.random.key(0), temperature=0.0,
        max_new_tokens=192)
    assert dev_ids == jdev_ids and dev_text == jdev_text
    assert set(dfa._device_arrays) == {"cpu"}          # tables uploaded once, cached


def test_sampled_device_run_is_valid(models):
    _, _, pp, pcfg = models
    fcfg = TC.FSMConfig(max_caption_chars=24)
    dfa = TC.compile_dfa(VOCAB, cfg=fcfg)
    gen = torch.Generator().manual_seed(7)
    ids, text = tlm.generate_with_fsm_device(pp, pcfg, PROMPT, dfa, VOCAB, gen,
                                             temperature=0.9, max_new_tokens=192)
    assert text.endswith("</think>")
    fsm = TC.MetadataFSM(fcfg)
    for t in ids:
        assert fsm.allowed(VOCAB)[t], f"illegal sampled token {t}={VOCAB[t]!r}"
        fsm.step(VOCAB[t])
    assert fsm.done


def test_planted_faults_change_the_tokens(models):
    """The two faults chip_smoke.py plants in the tables (the caption budget or
    the exception table left out) each change the greedy run's tokens."""
    _, _, pp, pcfg = models
    fcfg = TC.FSMConfig(max_caption_chars=24)
    dfa = TC.compile_dfa(VOCAB, cfg=fcfg)
    good, _ = tlm.generate_with_fsm_device(pp, pcfg, PROMPT, dfa, VOCAB, None, 0.0, 192)
    faults = {"caption budget dropped": dataclasses.replace(
                  dfa, is_caption=np.zeros_like(dfa.is_caption)),
              "exception table dropped": dataclasses.replace(
                  dfa, exc_tok=np.full_like(dfa.exc_tok, -1))}
    for fault, bad_dfa in faults.items():
        bad, _ = tlm.generate_with_fsm_device(pp, pcfg, PROMPT, bad_dfa, VOCAB, None, 0.0, 192)
        assert bad != good, fault


class PTok(_Tok):
    think_end_id = 1
    audio_code_base_id = 100

    def vocab_strs(self):
        return VOCAB


@pytest.mark.parametrize("device_fsm", [True, False], ids=["device_dfa", "host_fsm"])
def test_pipeline_constrained_cot_equal_jax(models, device_fsm, monkeypatch):
    params, cfg, pp, pcfg = models
    monkeypatch.setattr(jlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    monkeypatch.setenv("ACESTEP_TPU_DEVICE_FSM", "1" if device_fsm else "0")
    kw = dict(target_duration_s=2.0, temperature=0.0, thinking=True, constrained_cot=True,
              user_metadata={"bpm": 95}, max_cot_tokens=192, batch_size=2, chunk_size=2)
    ref = jlp.LMPipeline(dict(params), cfg, PTok()).generate_with_stop_condition(
        "warm", "la", **kw)
    pipe = tlp.LMPipeline(pp, pcfg, PTok(), device="cpu", device_fsm=device_fsm)
    res = pipe.generate_with_stop_condition("warm", "la", **kw)
    assert res.cot_route == ("device_dfa" if device_fsm else "host_fsm")
    assert res.cot_text == ref.cot_text
    assert res.metadata == ref.metadata
    for got, want in zip(res.candidates, ref.candidates, strict=True):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res.code_indices, ref.code_indices)
    assert len(res.code_indices) == 10
    assert "bpm: 95" in res.cot_text


def test_pipeline_falls_back_to_the_host_fsm(models, monkeypatch):
    """A DFA that cannot be compiled (a user duration outside its range leaves
    the done state unreachable) warns and takes the host FSM, which stops at
    the dead state: the same CoT as the JAX pipeline's."""
    params, cfg, pp, pcfg = models
    monkeypatch.setattr(jlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    kw = dict(target_duration_s=2.0, temperature=0.0, thinking=True, constrained_cot=True,
              user_metadata={"duration": 5}, max_cot_tokens=64)
    with pytest.warns(UserWarning, match="using host FSM"):
        ref = jlp.LMPipeline(dict(params), cfg, PTok()).generate_with_stop_condition(
            "warm", "la", **kw)
    pipe = tlp.LMPipeline(pp, pcfg, PTok(), device="cpu")
    with pytest.warns(UserWarning, match="using host FSM"):
        res = pipe.generate_with_stop_condition("warm", "la", **kw)
    assert res.cot_route == "host_fsm" and pipe.compiled_dfa({"duration": 5})[0] is None
    assert res.cot_text == ref.cot_text and "duration: " in res.cot_text
    np.testing.assert_array_equal(res.code_indices, ref.code_indices)
