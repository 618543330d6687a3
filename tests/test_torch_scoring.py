"""Port parity: acestep_tpu_torch.scoring (PMI reward ranking) against the JAX
package's scoring.py, on the CPU.

The LM is the JAX scoring test's TINY config (f32, 64 wide, 2 layers, vocab
128) with weights drawn from a numpy seed; the port gets them through
``weights.from_jax_numpy``, as a layer list and as the LM pipelines hold them
(stacked, q||k||v and gate||up fused).  ``sequence_logprob`` is held within
1e-3 x max(1, |value|) of the JAX function; rankings are compared on
candidates whose rewards lie further apart than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import lm_pipeline as jlp
from acestep_tpu import scoring as jscoring
from acestep_tpu.models import qwen as jqwen
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import lm_pipeline as tlp
from acestep_tpu_torch import scoring as tscoring
from acestep_tpu_torch import weights
from tests.test_lm_pipeline import MockTokenizer
from tests.test_scoring import TINY

TOL = 1e-3


@pytest.fixture(scope="module")
def lms():
    rng = np.random.default_rng(0)
    p = jqwen.init_params(jax.random.key(0), TINY, dtype=jnp.float32, scale=1.0,
                          sampler=lambda s: (rng.standard_normal(s) * 0.1).astype(np.float32))
    pcfg = tcfg.QwenConfig(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    tp = weights.from_jax_numpy(jax.tree_util.tree_map(np.asarray, p))
    jpipe = jlp.LMPipeline(p, TINY, MockTokenizer())
    tpipe = tlp.LMPipeline(tp, pcfg, MockTokenizer(), device="cpu")
    return {"layer_list": (p, tp), "pipeline": (jpipe.params, tpipe.params)}, pcfg


def _close(got, ref):
    assert abs(got - ref) <= TOL * max(1.0, abs(ref)), (got, ref)


@pytest.mark.parametrize("form", ["layer_list", "pipeline"])
def test_sequence_logprob(lms, form):
    trees, pcfg = lms
    jp, tp = trees[form]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, TINY.vocab_size, (3, 12))
    lengths, starts = np.array([12, 7, 9]), np.array([1, 3, 9])
    ref = np.asarray(jscoring.sequence_logprob(jp, TINY, jnp.asarray(ids, jnp.int32),
                                               jnp.asarray(lengths, jnp.int32),
                                               jnp.asarray(starts, jnp.int32)))
    got = tscoring.sequence_logprob(tp, pcfg, torch.from_numpy(ids), torch.from_numpy(lengths),
                                    torch.from_numpy(starts)).numpy()
    assert got.shape == ref.shape == (3,)
    assert ref[2] == 0.0 and got[2] == 0.0            # nothing left to score
    for g, r in zip(got, ref):
        _close(float(g), float(r))


@pytest.mark.parametrize("form", ["layer_list", "pipeline"])
def test_pmi_and_ranking(lms, form):
    trees, pcfg = lms
    jp, tp = trees[form]
    rng = np.random.default_rng(2)
    cond = [10, 11, 12, 13, 40, 41]
    # two lengths, so the JAX side compiles two programs per tree
    cands = [list(rng.integers(0, TINY.vocab_size, n)) for n in (6, 9, 6, 9, 6)]
    cands.append(cond + cond[:3])
    ref = jscoring.calculate_reward_scores(jp, TINY, cond, cands)
    got = tscoring.calculate_reward_scores(tp, pcfg, cond, cands)
    for g, r in zip(got, ref, strict=True):
        _close(g, r)
    # rankings compared where the rewards are told apart beyond the tolerance
    order = sorted(range(len(ref)), key=lambda i: -ref[i])
    gaps = [ref[order[i]] - ref[order[i + 1]] for i in range(len(order) - 1)]
    assert min(gaps) > 2 * TOL * max(1.0, max(abs(r) for r in ref)), gaps
    assert tscoring.rank_candidates(tp, pcfg, cond, cands) == \
        [int(i) for i in jscoring.rank_candidates(jp, TINY, cond, cands)] == order


def test_metadata_recall_equal():
    req = {"bpm": 120, "keyscale": "G major", "language": "en", "genres": "synthwave"}
    for got in ({"bpm": "120", "keyscale": "g major", "language": "EN"},
                {"bpm": "99", "keyscale": "G major", "language": "en",
                 "genres": "dark synthwave pop"},
                {}, {"bpm": 120}):
        for keys in (None, ["bpm"], ["genres", "language"]):
            assert tscoring.metadata_recall(req, got, keys) == \
                jscoring.metadata_recall(req, got, keys)
    assert tscoring.metadata_recall({}, {}) == jscoring.metadata_recall({}, {}) == 1.0
