"""Port parity of the continuous batcher (acestep_tpu_torch.serving.batcher)
against the JAX package's, on the CPU.

``merge_requests``, ``split_result`` and the shape-key grouping equal the JAX
functions on the same requests.  A ``ContinuousBatcher`` around a fake
``run_fn`` pads shorter requests up within ``pad_ratio``, schedules by
priority, caps merges at ``max_batch_for`` and refuses a clamped merge.  Last,
a mixed-duration batch through the batcher on a tiny engine, and one of its
requests alone (the segmented decode), match the JAX engine's per-item int16
under the whole-slice gate (cosine >= 0.999, SNR >= 26 dB over each item's
valid samples; tests/test_torch_pipeline.py), with the JAX engine's noise
passed to the port.
"""

import dataclasses
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.serving import batcher as jbatcher
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.serving import batcher as tbatcher
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, jax_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

GATE_COSINE = 0.999
GATE_SNR_DB = 26.0


def _pair(dur, style_len=6, lyric_len=None, seeds=(1,), batch=1, seed=0):
    """The same request in both packages."""
    rng = np.random.default_rng(seed)
    kw = dict(duration_s=dur, style_token_ids=rng.integers(0, 100, (1, style_len)),
              lyric_token_ids=rng.integers(0, 100, (1, lyric_len)) if lyric_len else None,
              seeds=list(seeds), batch_size=batch)
    return jpipeline.GenerationRequest(**kw), tpipeline.GenerationRequest(**kw)


MERGES = [
    [(10.0, 6, None, (1,)), (10.2, 9, None, (2,))],
    [(30.0, 6, 40, (0,)), (20.0, 40, None, (5,)), (60.0, 300, 9, (7,))],
    [(120.0, 64, 256, (3, 4), 2), (300.0, 64, None, (6,))],
]


@pytest.mark.parametrize("mi", range(len(MERGES)))
def test_merge_requests_matches_jax(mi):
    pairs = [_pair(*spec, seed=i) for i, spec in enumerate(MERGES[mi])]
    ref = jbatcher.merge_requests([j for j, _ in pairs])
    got = tbatcher.merge_requests([t for _, t in pairs])
    for f in ("batch_size", "duration_s", "durations_s", "seeds", "task", "shift",
              "timesteps"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("style_token_ids", "style_mask", "lyric_token_ids", "lyric_mask"):
        r, g = getattr(ref, f), getattr(got, f)
        assert (r is None) == (g is None), f
        if r is not None:
            np.testing.assert_array_equal(g, r)


def test_shape_keys_group_as_jax():
    pairs = [_pair(d, s, l) for d in (10.0, 10.2, 30.0) for s in (6, 20, 260)
             for l in (None, 9)]
    for ja, ta in pairs:
        for jb, tb in pairs:
            assert (tbatcher._shape_key(ta) == tbatcher._shape_key(tb)) == \
                (jbatcher._shape_key(ja) == jbatcher._shape_key(jb))
    with pytest.raises(ValueError, match="incompatible"):
        tbatcher.merge_requests([pairs[0][1], dataclasses.replace(pairs[0][1], shift=2.0)])


KEY_VARIANTS = [dict(audio_cover_strength=0.5), dict(repaint_start_s=2.0),
                dict(repaint_end_s=8.0), dict(guidance_scale=7.0), dict(infer_steps=32),
                dict(use_adg=True), dict(cfg_interval_start=0.1), dict(cfg_interval_end=0.9),
                dict(track_name="drums"), dict(complete_track_classes=["bass"]),
                dict(task="cover")]


@pytest.mark.parametrize("variant", range(len(KEY_VARIANTS)))
def test_merge_key_separates_task_fields_as_jax(variant):
    """A request that differs in one strength, span, CFG or track field does
    not merge, in either package."""
    ja, ta = _pair(10.0)
    kw = KEY_VARIANTS[variant]
    jb, tb = dataclasses.replace(ja, **kw), dataclasses.replace(ta, **kw)
    assert jbatcher._merge_key(ja) != jbatcher._merge_key(jb)
    assert tbatcher._merge_key(ta) != tbatcher._merge_key(tb)
    assert tbatcher._merge_key(tb) == tbatcher._merge_key(dataclasses.replace(ta, **kw))
    with pytest.raises(ValueError, match="incompatible"):
        tbatcher.merge_requests([ta, tb])


def _audio_pair(dur, seed, n_refer, lr, src_frames, batch=1):
    rng = np.random.default_rng(seed)
    kw = dict(duration_s=dur, style_token_ids=rng.integers(0, 100, (1, 6)), seeds=[seed],
              batch_size=batch, task="cover")
    if n_refer:
        kw["refer_latents"] = rng.standard_normal((1, n_refer, lr, 64)).astype(np.float32)
        kw["refer_mask"] = np.ones((1, n_refer), np.int32)
    if src_frames:
        kw["src_latents"] = rng.standard_normal((1, src_frames, 64)).astype(np.float32)
    return jpipeline.GenerationRequest(**kw), tpipeline.GenerationRequest(**kw)


@pytest.mark.parametrize("specs", [
    [(10.0, 0, 1, 200, 250), (20.0, 1, 2, 750, 500, 2)],
    [(30.0, 2, 0, 0, 750), (10.0, 3, 1, 100, 250)],
])
def test_merge_requests_audio_inputs_match_jax(specs):
    """Reference latents padded to the most clips and frames with each
    request's clips in the clip mask (zeros for a request without any);
    source latents zero-padded to the longest (batch 2 repeats its row); the
    shape key counts the clips."""
    pairs = [_audio_pair(*spec) for spec in specs]
    ref = jbatcher.merge_requests([j for j, _ in pairs])
    got = tbatcher.merge_requests([t for _, t in pairs])
    for f in ("refer_latents", "refer_mask", "src_latents"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.refer_latents.shape[0] == got.src_latents.shape[0] == got.batch_size
    keys = [tbatcher._shape_key(t) for _, t in pairs]
    jkeys = [jbatcher._shape_key(j) for j, _ in pairs]
    assert (keys[0] == keys[1]) == (jkeys[0] == jkeys[1]) is False
    assert [k[-1] for k in keys] == [k[-1] for k in jkeys] == [s[2] for s in specs]


def test_split_result_matches_jax():
    rng = np.random.default_rng(0)
    i16 = rng.integers(-3000, 3000, (3, 100, 2)).astype(np.int16)
    lat = rng.standard_normal((3, 10, 8)).astype(np.float32)
    kw = dict(latents=lat, sample_rate=48000, time_costs={"total_time_cost": 1.0},
              seeds=[1, 2, 3], audio_lengths=[100, 80, 60], audio_i16=i16, audio_scale=2000.0)
    ref = jbatcher.split_result(jpipeline.GenerationResult(**kw), [1, 2])
    got = tbatcher.split_result(tpipeline.GenerationResult(**kw), [1, 2])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.audio_i16, r.audio_i16)
        np.testing.assert_array_equal(g.latents, r.latents)
        assert (g.seeds, g.audio_lengths, g.audio_scale) == (r.seeds, r.audio_lengths,
                                                             r.audio_scale)
        np.testing.assert_array_equal(g.audio, r.audio)
    # one request passes through with its segments
    segs = [i16[:1, :40], i16[:1, 40:]]
    whole = tpipeline.GenerationResult(**dict(kw, latents=lat[:1], seeds=[1],
                                              audio_lengths=[100], audio_i16=None),
                                       audio_i16_segments=segs)
    (only,) = tbatcher.split_result(whole, [1])
    assert only is whole and only.pcm16_segments() is segs
    np.testing.assert_array_equal(only.audio_i16, i16[:1])


def _fake_result(req):
    b = req.batch_size
    return tpipeline.GenerationResult(
        latents=np.zeros((b, 4, 8), np.float32), sample_rate=48000, time_costs={},
        seeds=list(req.seeds), audio_scale=32767.0,
        audio_lengths=[tpipeline.frames_for_duration(d) * 1920 for d in req.durations_s],
        audio_i16=np.zeros((b, 10, 2), np.int16))


def _run_all(batcher, reqs, timeout=10):
    batcher.start()
    try:
        futs = [batcher.submit(r) for r in reqs]
        return [f.result(timeout=timeout) for f in futs]
    finally:
        batcher.stop()
        assert not batcher._thread.is_alive()


def test_batcher_pads_up_and_caps_admission():
    calls = []

    def run(req):
        calls.append(list(req.durations_s))
        return _fake_result(req)

    durations = [10.0, 10.2, 30.0, 30.5, 60.0, 120.0, 300.0, 600.0]
    reqs = [_pair(d, seeds=(i,))[1] for i, d in enumerate(durations)]
    # an admission cap of 2 at every bucket from 1536 frames on
    cap = {1536: 2, 3072: 2, 7680: 2, 15104: 1}
    b = tbatcher.ContinuousBatcher(run, max_batch=8, max_wait_s=0.3, pad_ratio=2.5,
                                   max_batch_for=lambda f: cap.get(f, 8))
    results = _run_all(b, reqs)
    for r, d, s in zip(results, durations, range(8)):
        assert r.audio_lengths == [tpipeline.frames_for_duration(d) * 1920] and r.seeds == [s]
    # buckets within 2.5x merge; the cap splits 30 + 30.5 + 60 (bucket 1536)
    assert calls == [[10.0, 10.2], [30.0, 30.5], [60.0, 120.0], [300.0], [600.0]]
    assert list(b.stats["merged_sizes"]) == [2, 2, 2, 1, 1]
    assert b.stats["padded_items"] == 1


def test_batcher_priority_and_clamp_check():
    order, gate = [], threading.Event()

    def run(req):
        gate.wait(timeout=5)
        order.append(req.durations_s)
        return _fake_result(req)

    b = tbatcher.ContinuousBatcher(run, max_batch=1, max_wait_s=0.05).start()
    try:
        first = b.submit(_pair(11.0)[1])
        time.sleep(0.15)
        low = b.submit(_pair(12.0)[1], priority=0)
        high = b.submit(_pair(13.0)[1], priority=5)
        gate.set()
        for f in (first, low, high):
            f.result(timeout=5)
    finally:
        b.stop()
    assert order == [[11.0], [13.0], [12.0]]

    def clamped(req):
        return _fake_result(dataclasses.replace(req, batch_size=1, durations_s=[10.0]))

    b = tbatcher.ContinuousBatcher(clamped, max_batch=2, max_wait_s=0.05).start()
    try:
        futs = [b.submit(_pair(10.0)[1]), b.submit(_pair(10.1)[1])]
        for f in futs:
            with pytest.raises(RuntimeError, match="returned 1 items for a merged batch of 2"):
                f.result(timeout=5)
    finally:
        b.stop()


def _item_gate(ref_audio, got_audio, n):
    ref, got = ref_audio[:n].ravel(), got_audio[:n].ravel()
    assert np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, got), eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def test_engine_backed_mixed_batch_matches_jax(monkeypatch):
    # the JAX engine's q8_0 linears through its XLA path, as on the CPU
    # everywhere else in these tests (its Pallas default runs only on a TPU)
    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")
    dp, tp, vp = jax_params(seed=3)
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    dim = TINY_DIT.audio_acoustic_hidden_dim

    def jax_noise(req):
        t = tpipeline.bucket_frames(tpipeline.frames_for_duration(req.duration_s))
        return torch.from_numpy(np.asarray(
            jsampler.make_noise(list(req.seeds), (req.batch_size, t, dim))))

    # 30 s and 20 s: buckets 768 and 512 (ratio 1.5) merge; two decode windows
    durations = (30.0, 20.0)
    pairs = [_pair(d, style_len=20, lyric_len=40, seeds=(i + 1,), seed=i)
             for i, d in enumerate(durations)]
    batcher = tbatcher.ContinuousBatcher(lambda r: teng.generate(r, noise=jax_noise(r)),
                                         max_batch=2, max_wait_s=0.2,
                                         max_batch_for=teng.max_batch_for_frames)
    got = _run_all(batcher, [t for _, t in pairs], timeout=300)
    assert list(batcher.stats["merged_sizes"]) == [2]
    ref = jeng.generate(jbatcher.merge_requests([j for j, _ in pairs]))
    for i, (r, d) in enumerate(zip(got, durations)):
        n = tpipeline.frames_for_duration(d) * SLICE_VAE.hop_length
        assert r.audio_lengths == [n] == [ref.audio_lengths[i]]
        assert r.audio_i16.shape == (1, 750 * SLICE_VAE.hop_length, 2)
        _item_gate(ref.audio[i], r.audio[0], n)

    # the 30 s request alone: b = 1 with two windows takes the segmented decode
    solo_j, solo_t = pairs[0]
    ref = jeng.generate(solo_j)
    res = teng.generate(solo_t, noise=jax_noise(solo_t))
    assert res.time_costs["vae_overlapped"] == 1.0 == ref.time_costs["vae_overlapped"]
    assert len(res.pcm16_segments()) == len(ref.pcm16_segments()) == 2
    assert res.audio_i16.shape == ref.audio_i16.shape
    _item_gate(ref.audio[0], res.audio[0], res.audio_lengths[0])


def test_merged_item_equals_solo_run():
    """A merged item against the same request alone, with the same noise: on
    the CPU its latents are equal bit for bit (masked keys add exact zeros),
    and its audio is equal up to one decode overlap (64 frames) before its end
    but for the int16 scale (the batch shares one; >= 80 dB).  Past that, the
    merged decode reads the padded frames, as the JAX engine's does."""
    dp, tp, vp = jax_params(seed=3)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    reqs = [_pair(d, style_len=20, lyric_len=40, seeds=(i,), seed=i)[1]
            for i, d in enumerate((20.0, 60.0))]
    merged = tbatcher.merge_requests(reqs)
    noise = torch.randn((2, 1536, TINY_DIT.audio_acoustic_hidden_dim),
                        generator=torch.Generator().manual_seed(9))
    res = teng.generate(merged, noise=noise)
    solo = teng.generate(reqs[0], noise=noise[:1, :512])
    assert res.audio_lengths == [500 * SLICE_VAE.hop_length, 1500 * SLICE_VAE.hop_length]
    np.testing.assert_array_equal(res.latents[0, :500], solo.latents[0])
    n = (500 - 64) * SLICE_VAE.hop_length
    ref, got = solo.audio[0, :n].ravel(), res.audio[0, :n].ravel()
    assert eval_metrics.snr_db(ref, got) >= 80.0
