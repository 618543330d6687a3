"""Port parity of the window-grouped and segmented VAE decodes
(acestep_tpu_torch.models.vae; pipeline.segment_windows, reconcile_segments and
the decode helpers)
against the JAX package's ``fused_tiled_decode_int16`` and
``fused_decode_windows_int16`` on the CPU, at ``max_window_batch`` 1, 2 and 3.

Two decoders:
  * a stand-in whose f32 arithmetic is exact in both packages (a two-tap
    filter over time by a power-of-two weight, then a hold of ``hop``
    samples), so the window plan, the (size, trim) grouping, the window-major
    (window x item) stacking, the bounded calls, the trims, the peak scale and
    the reconciliation are held to the JAX package bit for bit: the int16 and
    the scales are equal on quiet and on loud latents;
  * the real decoder (SLICE_VAE), whose f32 convolutions sum in another order
    in each package (and in each package at another window batch): the int16
    then agrees within one step at every sample.
Segments reconciled to the lowest scale equal a one-pass decode exactly where
no segment's peak passed 0.99 (quiet), and within one step where one did.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.models import vae as jvae
from acestep_tpu_torch import memory_planner
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import vae as tvae
from tests.test_torch_models import SLICE_VAE, jax_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

HOP = SLICE_VAE.hop_length
T, CHUNK = 44, 8                       # 11 windows: sizes 6, 8, 6 and a ragged last one
AMP = {"quiet": 0.04, "loud": 4.0}      # stand-in peaks below and above 0.99


def _jax_standin(params, cfg, z):
    y = z[..., :2]
    y = y + 0.5 * jnp.pad(y, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    return jnp.repeat(y, HOP, axis=1)


def _torch_standin(params, cfg, z):
    y = z[..., :2]
    y = y + 0.5 * torch.nn.functional.pad(y, (0, 0, 1, 0))[:, :-1]
    return torch.repeat_interleave(y, HOP, dim=1)


@pytest.fixture
def standin(monkeypatch):
    monkeypatch.setattr(jvae, "decode", _jax_standin)
    monkeypatch.setattr(tvae, "decode", _torch_standin)


def _latents(b, amp, seed=3):
    lat = np.random.default_rng(seed).standard_normal((b, T, 8)).astype(np.float32) * amp
    lat[:, 30:34] *= 3.0          # one window louder than the rest
    return lat


def _jax_tiled(params, lat, wb):
    """The JAX function eagerly (its jit would keep a trace of the stand-in)."""
    i16, scale = jvae.fused_tiled_decode_int16.__wrapped__(
        params, SLICE_VAE, jnp.asarray(lat), chunk_frames=CHUNK, max_window_batch=wb)
    return np.asarray(i16), float(scale)


def _port_segments(params, lat, wb):
    windows = tvae._window_plan(T, CHUNK, None)
    plan = tpipeline.segment_windows(windows, CHUNK)
    out = [tvae.fused_decode_windows_int16(params, port_cfg(SLICE_VAE),
                                           torch.from_numpy(lat[:, lo:hi]), rel,
                                           max_window_batch=wb)
           for lo, hi, rel in plan]
    return plan, [(i16.numpy(), float(s)) for i16, s in out]


@pytest.mark.parametrize("wb", [1, 2, 3])
@pytest.mark.parametrize("loudness", ["quiet", "loud"])
def test_window_groups_equal_jax_exactly(standin, wb, loudness):
    lat = _latents(2, AMP[loudness])
    ref_i16, ref_scale = _jax_tiled({}, lat, wb)
    i16, scale = tvae.fused_tiled_decode_int16({}, port_cfg(SLICE_VAE), torch.from_numpy(lat),
                                               chunk_frames=CHUNK, max_window_batch=wb)
    assert (float(scale) < 32767.0) == (loudness == "loud")
    assert float(scale) == ref_scale
    np.testing.assert_array_equal(i16.numpy(), ref_i16)


@pytest.mark.parametrize("wb", [1, 2, 3])
@pytest.mark.parametrize("loudness", ["quiet", "loud"])
def test_segments_equal_jax_exactly(standin, wb, loudness):
    lat = _latents(1, AMP[loudness])
    plan, fetched = _port_segments({}, lat, wb)
    assert [len(rel) for _, _, rel in plan] == [5, 5, 1]
    for (lo, hi, rel), (i16, scale) in zip(plan, fetched):
        ref_i16, ref_scale = jvae.fused_decode_windows_int16.__wrapped__(
            {}, SLICE_VAE, jnp.asarray(lat[:, lo:hi]), tuple(map(tuple, rel)),
            max_window_batch=wb)
        assert scale == float(ref_scale)
        np.testing.assert_array_equal(i16, np.asarray(ref_i16))
    segments, scale = tpipeline.reconcile_segments(fetched, 2)
    whole, whole_scale = _jax_tiled({}, lat, wb)
    got = np.concatenate(segments, axis=1).reshape(-1)
    assert scale == whole_scale
    scales = {s for _, s in fetched}
    if loudness == "quiet":
        assert scales == {32767.0}
        np.testing.assert_array_equal(got, whole)
    else:
        assert len(scales) > 1       # the loud window's segment sets the scale
        assert np.abs(got.astype(np.int32) - whole.astype(np.int32)).max() == 1


def test_segment_plan():
    windows = tvae._window_plan(15000, 512, None)
    plan = tpipeline.segment_windows(windows, 512)
    assert len(windows) == 40 and len(plan) == 10       # a 600 s song
    assert plan[0][0] == 0 and plan[-1][1] == 15000
    for (lo, hi, rel), i in zip(plan, range(0, 40, 4)):
        assert [(cs + lo, ce + lo, ws + lo, we + lo) for cs, ce, ws, we in rel] == \
            windows[i:i + 4]
    assert len(tpipeline.segment_windows(tvae._window_plan(1500, 512, None), 512)) == 2


@pytest.mark.parametrize("plan_chunk", [16, 40, 1000])      # clamped up, kept, clamped down
def test_decode_helpers_follow_the_plan(standin, plan_chunk):
    """``pipeline.decode_one_pass`` and ``decode_segments`` decode at the
    plan's chunk clamped to [32, 512] and at its window batch: the one pass
    and the reconciled segments equal the JAX one pass there (quiet)."""
    chunk = min(max(plan_chunk, 32), 512)
    plan = memory_planner.Plan(max_batch=1, vae_chunk_frames=plan_chunk, fits=True, detail={},
                               vae_window_batch=2)
    assert tpipeline.decode_chunk(plan) == chunk
    lat = np.random.default_rng(5).standard_normal((1, 100, 8)).astype(np.float32) * 0.04
    ref_i16, ref_scale = jvae.fused_tiled_decode_int16.__wrapped__(
        {}, SLICE_VAE, jnp.asarray(lat), chunk_frames=chunk, max_window_batch=2)
    ref_i16 = np.asarray(ref_i16).reshape(-1)
    i16, scale = tpipeline.decode_one_pass({}, port_cfg(SLICE_VAE), torch.from_numpy(lat), plan)
    assert float(scale) == float(ref_scale) == 32767.0
    np.testing.assert_array_equal(i16.numpy().reshape(-1), ref_i16)
    handles = tpipeline.decode_segments({}, port_cfg(SLICE_VAE), torch.from_numpy(lat), plan)
    windows = tvae._window_plan(100, chunk, None) if chunk < 100 else []
    n_seg = len(tpipeline.segment_windows(windows, chunk)) if len(windows) >= 2 else 0
    assert len(handles) == n_seg and (n_seg >= 2) == (plan_chunk < 100)
    if handles:
        segments, s = tpipeline.reconcile_segments(
            [(h.numpy(), float(sc)) for h, sc in handles], 2)
        assert s == float(ref_scale)
        np.testing.assert_array_equal(np.concatenate(segments, axis=1).reshape(-1), ref_i16)


@pytest.fixture(scope="module")
def vae_params():
    _, _, vp = jax_params(seed=5, vae_affine_scale=0.1)
    return vp, weights.from_jax_numpy(to_np(vp))


@pytest.mark.parametrize("wb", [1, 2, 3])
def test_real_decoder_within_one_step(vae_params, wb):
    """b = 2 window groups and b = 1 segments of the real decoder: within one
    int16 step of the JAX package at every sample, scales within f32 noise."""
    vp, tvp = vae_params
    lat = _latents(2, 0.5, seed=7)
    ref_i16, ref_scale = jvae.fused_tiled_decode_int16(
        vp, SLICE_VAE, jnp.asarray(lat), chunk_frames=CHUNK, max_window_batch=wb)
    i16, scale = tvae.fused_tiled_decode_int16(tvp, port_cfg(SLICE_VAE),
                                               torch.from_numpy(lat), chunk_frames=CHUNK,
                                               max_window_batch=wb)
    np.testing.assert_allclose(float(scale), float(ref_scale), rtol=1e-5)
    assert np.abs(i16.numpy().astype(np.int32) - np.asarray(ref_i16).astype(np.int32)).max() <= 1
    plan, fetched = _port_segments(tvp, lat[:1], wb)
    for (lo, hi, rel), (seg, s) in zip(plan, fetched):
        ref_seg, ref_s = jvae.fused_decode_windows_int16(
            vp, SLICE_VAE, jnp.asarray(lat[:1, lo:hi]), tuple(map(tuple, rel)),
            max_window_batch=wb)
        np.testing.assert_allclose(s, float(ref_s), rtol=1e-5)
        assert np.abs(seg.astype(np.int32) - np.asarray(ref_seg).astype(np.int32)).max() <= 1
