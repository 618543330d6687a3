"""Port parity: acestep_tpu_torch.constrained (the port's own copy of the
metadata FSM and its DFA compiler) against the JAX package's constrained.py.

Pure numpy on both sides, so everything is held for equality: every field of
the compiled DFA, and the host FSM's masks along seeded random walks.  The
vocabularies: the synthetic VOCAB of tests/test_device_fsm.py and the first
4096 pieces of the demo vocabulary of tools/bench_full_pipeline.py (the same
piece mix as chip_smoke.py's full-width one).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from acestep_tpu import constrained as JC
from acestep_tpu_torch import constrained as TC
from tests.test_device_fsm import VOCAB

REPO = pathlib.Path(__file__).resolve().parents[1]
USER_METADATA = [{}, {"bpm": 120, "duration": 60}, {"caption": "fixed words", "keyscale": "C major"}]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEMO = _load("tools/bench_full_pipeline.py", "_bench_full_pipeline").build_demo_vocab(4096)
VOCABS = {"test_vocab": VOCAB, "demo4096": DEMO}


def test_constants_equal():
    for name in ("FIELD_ORDER", "KEYS", "KEYSCALES", "LANGUAGES", "DEFAULT_GENRES",
                 "FIELD_RANGES"):
        assert getattr(TC, name) == getattr(JC, name), name
    assert TC.FSMConfig().genres_vocab == JC.FSMConfig().genres_vocab
    assert TC.FSMConfig().max_caption_chars == JC.FSMConfig().max_caption_chars


def test_chip_smoke_demo_vocab_is_the_bench_one():
    smoke = _load("chip_smoke.py", "_chip_smoke")
    assert smoke.build_demo_vocab(4096) == DEMO
    assert smoke.build_demo_vocab(151669)[:4096] == DEMO


def test_load_genres_vocab_path(tmp_path):
    f = tmp_path / "genres.txt"
    f.write_text("# comment\nshoegaze\n\n  dream pop \n")
    assert TC.load_genres_vocab(str(f)) == JC.load_genres_vocab(str(f)) == ["shoegaze", "dream pop"]
    missing = str(tmp_path / "none.txt")
    assert TC.load_genres_vocab(missing) == JC.load_genres_vocab(missing) == JC.DEFAULT_GENRES


@functools.lru_cache(maxsize=None)
def _port_dfa(vocab, md_index):
    """The port's DFA of a vocabulary and a USER_METADATA entry, compiled once
    for the tests of this file."""
    return TC.compile_dfa(VOCABS[vocab], user_metadata=USER_METADATA[md_index])


def _assert_dfa_equal(got, ref):
    for field in dataclasses.fields(JC.CompiledDFA):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


MD_IDS = ["none", "bpm_duration", "caption_key"]


@pytest.mark.parametrize("md_index", range(len(USER_METADATA)), ids=MD_IDS)
@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_compiled_dfa_equal(vocab, md_index):
    """Every CompiledDFA field equal to the JAX compile_dfa's, bit for bit."""
    _assert_dfa_equal(_port_dfa(vocab, md_index),
                      JC.compile_dfa(VOCABS[vocab], user_metadata=USER_METADATA[md_index]))


def test_compiled_dfa_equal_small_budget():
    cfg_t, cfg_j = TC.FSMConfig(max_caption_chars=8), JC.FSMConfig(max_caption_chars=8)
    _assert_dfa_equal(TC.compile_dfa(VOCAB, cfg=cfg_t), JC.compile_dfa(VOCAB, cfg=cfg_j))
    with pytest.raises(TC.DFACompileError):
        TC.compile_dfa(VOCAB, max_states=5)
    with pytest.raises(JC.DFACompileError):
        JC.compile_dfa(VOCAB, max_states=5)


@pytest.mark.parametrize("md_index", range(len(USER_METADATA)), ids=MD_IDS)
@pytest.mark.parametrize("vocab", sorted(VOCABS))
def test_fsm_masks_equal_along_walks(vocab, md_index):
    """Seeded random walks: the port's MetadataFSM mask equals the JAX one at
    every step, and the port's DFA (host_mask / host_step) follows it: two
    walks on the test vocabulary, one on the 4096-piece one (each step scans
    the vocabulary in Python three times)."""
    v, user_metadata = VOCABS[vocab], USER_METADATA[md_index]
    rng = np.random.default_rng(0)
    dfa = _port_dfa(vocab, md_index)
    for walk in range(2 if vocab == "test_vocab" else 1):
        fsm_t = TC.MetadataFSM(user_metadata=user_metadata)
        fsm_j = JC.MetadataFSM(user_metadata=user_metadata)
        state, used = dfa.start_state, 0
        for _ in range(300):
            assert fsm_t.done == fsm_j.done
            if fsm_t.done:
                assert state == dfa.done_state
                break
            mask = fsm_t.allowed(v)
            np.testing.assert_array_equal(mask, fsm_j.allowed(v))
            np.testing.assert_array_equal(dfa.host_mask(state, used), mask)
            choices = mask.nonzero()[0]
            if not choices.size:
                break
            tok = int(rng.choice(choices))
            fsm_t.step(v[tok])
            fsm_j.step(v[tok])
            state, used = dfa.host_step(state, used, tok)
        else:
            pytest.fail("walk did not end in 300 steps")


def test_caption_budget_matches_host():
    """test_device_fsm.py's caption-budget case on the port: the DFA's char
    register cuts free text exactly where the host FSM does, and both agree
    with the JAX FSM."""
    cfg = TC.FSMConfig(max_caption_chars=8)
    dfa = TC.compile_dfa(VOCAB, cfg=cfg)
    fsm = TC.MetadataFSM(cfg)
    fsm_j = JC.MetadataFSM(JC.FSMConfig(max_caption_chars=8))
    state, used = dfa.start_state, 0
    guard = 0
    while not (fsm.current_field == "caption" and fsm.mode == "value"
               and fsm.forced_text is None):
        host = fsm.allowed(VOCAB)
        np.testing.assert_array_equal(host, fsm_j.allowed(VOCAB))
        tok = int(host.nonzero()[0][0])
        fsm.step(VOCAB[tok])
        fsm_j.step(VOCAB[tok])
        state, used = dfa.host_step(state, used, tok)
        guard += 1
        assert guard < 200
    assert dfa.is_caption[state]
    assert used == len(fsm.value_text)
    fsm.step("hello")
    fsm_j.step("hello")
    state, used = dfa.host_step(state, used, VOCAB.index("hello"))
    host = fsm.allowed(VOCAB)
    np.testing.assert_array_equal(dfa.host_mask(state, used), host)
    np.testing.assert_array_equal(host, fsm_j.allowed(VOCAB))
    assert not host[VOCAB.index(" world")]
    assert host[VOCAB.index("tex")]


def test_fsm_generate_text_equal():
    """fsm_generate_text with a deterministic sampler (the last allowed id)."""
    def last(mask):
        return int(mask.nonzero()[0][-1])

    for md in USER_METADATA:
        assert TC.fsm_generate_text(TC.MetadataFSM(user_metadata=md), last, VOCAB) == \
            JC.fsm_generate_text(JC.MetadataFSM(user_metadata=md), last, VOCAB)
