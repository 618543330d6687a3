"""Port parity of the lyric alignment (acestep_tpu_torch.alignment and
``AceStepEngine.get_lyric_timestamps`` / ``get_lyric_score``) against the
JAX package, on the CPU.

The DTW, timestamp, score and LRC functions are numpy copies: exact on the
same arrays.  The probe runs the DiT layers once in bf16 on a q8_0 tree (the
dequant-matmul's plain version here), with the JAX package's ``eps`` passed
in (torch cannot draw ``jax.random``).  XLA fuses bf16 ops that torch rounds
one by one, so the maps (probabilities of order 1 / Lc) are held to 2e-3
absolute and the score to 1e-3 relative.  The timestamps come from a DTW
path through the map, which a small difference can move by one patch at a
token whose attention is flat: every stamp is held within one patch
(0.08 s) of the JAX one and at least 90% of them equal.  Through the engine
the condition (text and lyric encoders, bf16) differs from the JAX one by a
few bf16 steps too (as tests/test_torch_models.py allows); measured, that
moves the maps by 3.6e-4 (the probe alone, on the JAX condition: 2.8e-4) and
the score by 1.7e-3 relative (the probe alone: 2.3e-5), so the engine's score
is held to 5e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import alignment as jalign
from acestep_tpu import pipeline as jpipeline
from acestep_tpu.models import dit as jdit
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import alignment as talign
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import (KERNEL_GAIN, SLICE_VAE, _quant_policy, _scale_kernels,
                                     jax_params, port_cfg, to_np)

MAP_ATOL = 2e-3
SCORE_RTOL = 1e-3
ENGINE_SCORE_RTOL = 5e-3
STAMP_EQUAL_SHARE = 0.9


def _maps(seed, shape):
    rng = np.random.default_rng(seed)
    m = rng.random(shape)
    # a noisy diagonal ridge, as a probe of a sung lyric gives
    t, n = shape
    for i in range(t):
        m[i, min(n - 1, i * n // t)] += 2.0
    return m / m.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("seed,shape", [(0, (1, 1)), (1, (1, 7)), (2, (9, 1)), (3, (20, 9)),
                                        (4, (128, 40)), (5, (33, 60))])
def test_dtw_timestamps_score_lrc_exact(seed, shape):
    m = _maps(seed, shape)
    assert talign.dtw_path(m) == jalign.dtw_path(m)
    n = shape[1]
    for k in {1, max(1, n // 2), n}:
        np.testing.assert_array_equal(talign.token_timestamps(m, k, 0.08),
                                      jalign.token_timestamps(m, k, 0.08))
        assert talign.alignment_score(m, k) == jalign.alignment_score(m, k)
    stamps = jalign.token_timestamps(m, n, 1.37)
    lines = [f"line {i}" for i in range(4)]
    counts = [max(1, n // 4)] * 4
    assert talign.to_lrc(lines, counts, stamps) == jalign.to_lrc(lines, counts, stamps)
    assert talign.to_lrc(lines, counts, np.zeros(0)) == jalign.to_lrc(lines, counts, np.zeros(0))


# three layers (sliding, full, sliding) at the tiny width
PROBE_DIT = dataclasses.replace(TINY_DIT, num_hidden_layers=3, layer_types=())


@pytest.fixture(scope="module")
def probe_params():
    rng = np.random.default_rng(11)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return quantize_tree_jax(_scale_kernels(jdit.init_params(jax.random.key(1), PROBE_DIT,
                                                             sampler=sampler), KERNEL_GAIN),
                             "q8_0", policy=_quant_policy)


@pytest.mark.parametrize("t_len", [40, 37])
def test_cross_attention_maps_match_jax(probe_params, t_len):
    assert PROBE_DIT.layer_types[0] == "sliding_attention"
    rng = np.random.default_rng(t_len)
    lc = 24
    lat = rng.standard_normal((1, t_len, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, t_len, 16)).astype(np.float32)
    enc = rng.standard_normal((1, lc, 64)).astype(np.float32)
    mask = np.ones((1, lc), np.int32)
    mask[:, 19:] = 0                                  # padded condition tokens
    key = jax.random.key(3)
    eps = np.asarray(jax.random.normal(key, lat.shape, jnp.float32))
    ref = np.asarray(jalign.cross_attention_maps(
        probe_params, PROBE_DIT, jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(enc),
        jnp.asarray(mask), noise_key=key))
    got = talign.cross_attention_maps(
        weights.from_jax_numpy(to_np(probe_params)), port_cfg(PROBE_DIT),
        torch.from_numpy(lat), torch.from_numpy(ctx), torch.from_numpy(enc),
        torch.from_numpy(mask), eps=torch.from_numpy(eps)).numpy()
    assert got.shape == ref.shape == (1, (t_len + 1) // 2, lc)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
    assert np.abs(got[..., 19:]).max() < 1e-6                 # masked tokens get nothing
    err = float(np.abs(got - ref).max())
    assert err <= MAP_ATOL, err
    s_ref, s_got = jalign.alignment_score(ref[0], 19), talign.alignment_score(got[0], 19)
    assert abs(s_got - s_ref) <= SCORE_RTOL * abs(s_ref), (s_got, s_ref)


def test_lyric_timestamps_and_score_match_jax():
    dp, tp, vp = jax_params(seed=3)
    rng = np.random.default_rng(7)
    t_valid = 250                                    # 10 s in a 256-frame bucket
    lat = rng.standard_normal((1, t_valid, TINY_DIT.audio_acoustic_hidden_dim)).astype(np.float32)
    style = rng.integers(0, TINY_TEXT.vocab_size, (1, 20))
    lyric = rng.integers(0, TINY_TEXT.vocab_size, (1, 40))
    lines, counts = ["first line", "second line", "third"], [14, 13, 13]
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    jreq = jpipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1])
    ref_stamps, ref_lrc = jeng.get_lyric_timestamps(lat, jreq, lines, counts)
    ref_score = jeng.get_lyric_score(lat, jreq)

    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    treq = tpipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1])
    # the JAX probe's draw: key(0) at the bucket-padded shape
    eps = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.key(0), (1, 256, TINY_DIT.audio_acoustic_hidden_dim), jnp.float32)))
    stamps, lrc = teng.get_lyric_timestamps(lat, treq, lines, counts, eps=eps)
    score = teng.get_lyric_score(lat, treq, eps=eps)

    patch_s = TINY_DIT.patch_size / 25.0
    assert stamps.shape == ref_stamps.shape == (40,)
    assert np.abs(stamps - ref_stamps).max() <= patch_s + 1e-9
    assert np.mean(np.abs(stamps - ref_stamps) < 1e-9) >= STAMP_EQUAL_SHARE
    assert lrc.count("\n") == 2 and lrc.startswith("[00:")
    assert abs(score - ref_score) <= ENGINE_SCORE_RTOL * abs(ref_score), (score, ref_score)
    # the default draw (seeded torch) runs and is repeatable
    s1, _ = teng.get_lyric_timestamps(lat, treq)
    s2, _ = teng.get_lyric_timestamps(lat, treq)
    np.testing.assert_array_equal(s1, s2)
    with pytest.raises(ValueError, match="no lyric tokens"):
        teng.get_lyric_timestamps(lat, tpipeline.GenerationRequest(style_token_ids=style))
