"""Port parity of the audio-code bridge (acestep_tpu_torch.models.codec), the
code-hint branch of ``inference.generate_music`` and ``inference.understand_audio``
(with ``training.dataset_builder.audio_to_codes``) against the JAX package, on
the CPU.

Codec weights are the JAX package's ``init_arch_params`` for each of its three
archs (32 channels, the tiny DiT's 8 latent channels), carried to the port
through numpy.  Tolerances: the FSQ map exactly in both directions; the
detokenizer's f32 latents within 1e-4 of the peak; codes equal except where
the JAX side's pre-rounding FSQ value lies within 1e-4 of a rounding edge
(two correct f32 sums may round to either side there); a checkpoint's tensors
exactly.  The LM is a stub that returns fixed codes: the LM itself is held to
the JAX package in tests/test_torch_inference.py.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import inference as jinf
from acestep_tpu import pipeline as jpipeline
from acestep_tpu.models import codec as jcodec
from acestep_tpu.utils.safetensors_io import SafetensorsFile as JSafetensorsFile
from acestep_tpu.utils.safetensors_io import save_safetensors
from acestep_tpu_torch import inference as tinf
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import codec as tcodec
from acestep_tpu_torch.serving import launch as tlaunch
from acestep_tpu_torch.training import dataset_builder as tdb
from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import F32_REL_MAX, SLICE_VAE, jax_params, port_cfg, to_np

ARCHS = ("conv_v1", "fsq_linear", "rfsq_conv")
DIM = TINY_DIT.audio_acoustic_hidden_dim
EDGE = 1e-4


def _codec(arch, seed=0):
    jp = jcodec.init_arch_params(arch, jax.random.key(seed), hidden=32, latent_dim=DIM)
    return jp, weights.from_jax_numpy(to_np(jp))


def _near_edge(values: np.ndarray) -> np.ndarray:
    """[.., 6] FSQ values -> [..] True where a digit lies within EDGE of its
    rounding edge (in value units)."""
    near = np.zeros(values.shape[:-1], bool)
    for i, lvl in enumerate(jcodec.FSQ_LEVELS):
        u = (values[..., i].astype(np.float64) + 1.0) * (lvl - 1) / 2.0
        near |= np.abs(u - np.floor(u) - 0.5) * 2.0 / (lvl - 1) < EDGE
    return near


@pytest.fixture
def seen_values(monkeypatch):
    """The values the JAX tokenizer rounds, recorded as it runs."""
    seen = []
    orig = jcodec.values_to_indices

    def record(v):
        seen.append(np.asarray(v))
        return orig(v)

    monkeypatch.setattr(jcodec, "values_to_indices", record)
    return seen


def _codes_equal_off_edge(got, ref, values):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    differ = got != ref
    assert not (differ & ~_near_edge(values)).any(), int((differ & ~_near_edge(values)).sum())
    assert differ.mean() < 0.05


def test_fsq_map_exact_both_ways():
    idx = np.arange(64000, dtype=np.int32)
    ref = np.asarray(jcodec.indices_to_values(jnp.asarray(idx)))
    got = tcodec.indices_to_values(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    back = tcodec.values_to_indices(torch.from_numpy(got))
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), idx)
    np.testing.assert_array_equal(np.asarray(jcodec.values_to_indices(jnp.asarray(ref))), idx)
    # off-grid values: clipped and rounded half to even in both packages
    v = np.random.default_rng(0).uniform(-1.5, 1.5, (4096, 6)).astype(np.float32)
    v[:6] = [[-1.0, -1 + 1 / 7, 1 / 7, 0.5, 0.25, -0.75]] * 6        # exact halves
    np.testing.assert_array_equal(tcodec.values_to_indices(torch.from_numpy(v)).numpy(),
                                  np.asarray(jcodec.values_to_indices(jnp.asarray(v))))


@pytest.mark.parametrize("arch", ARCHS)
def test_detokenize_and_tokenize_match_jax(arch, seen_values):
    jp, tp = _codec(arch)
    assert tcodec.get_arch(tp)[0] == arch
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 64000, (2, 20)).astype(np.int32)
    ref = np.asarray(jcodec.detokenize(jp, jnp.asarray(codes)))
    got = tcodec.detokenize(tp, torch.from_numpy(codes)).numpy()
    assert got.shape == ref.shape == (2, 100, DIM)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_REL_MAX * np.abs(ref).max())
    lat = rng.standard_normal((2, 103, DIM)).astype(np.float32)
    ref_idx = np.asarray(jcodec.tokenize(jp, jnp.asarray(lat)))
    got_idx = tcodec.tokenize(tp, torch.from_numpy(lat))
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, 20)
    _codes_equal_off_edge(got_idx.numpy(), ref_idx, seen_values[-1])


def test_codes_to_latents_pad_and_crop():
    jp, tp = _codec("fsq_linear", 2)
    codes = np.random.default_rng(3).integers(0, 64000, 12)
    for target in (40, 60, 75):       # crop, exact, zero-pad
        ref = np.asarray(jcodec.codes_to_latents(jp, codes, target))
        got = tcodec.codes_to_latents(tp, codes, target).numpy()
        assert got.shape == ref.shape == (1, target, DIM)
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_REL_MAX * np.abs(ref).max())
        assert not got[0, 60:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_load_from_a_jax_written_checkpoint(arch, tmp_path):
    """Tensors exported by the JAX to_checkpoint_tensors (torch layout, one
    under a ``model.`` prefix, beside a tensor that is not the codec's) load
    into the same tree; the port's export equals the JAX one; a missing tensor
    or an unknown arch raises with the name diff."""
    jp, tp = _codec(arch, 4)
    tensors = jcodec.to_checkpoint_tensors(jp)
    export = tcodec.to_checkpoint_tensors(tp)
    assert export.keys() == tensors.keys()
    for k in tensors:
        np.testing.assert_array_equal(export[k], tensors[k])
    stem = tcodec.ARCH_SPECS[arch][0][1]
    stored = {("model." + k if k.startswith(stem + ".") else k): v for k, v in tensors.items()}
    stored["decoder.conv_in.weight"] = np.zeros((2, 2, 1), np.float32)
    path = str(tmp_path / "dit.safetensors")
    save_safetensors(path, stored)
    got = tcodec.load_from_checkpoint(SafetensorsFile(path))
    ref = jcodec.load_from_checkpoint(JSafetensorsFile(path))
    assert tcodec.get_arch(got)[0] == arch
    flat_ref = {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    flat_got = {jax.tree_util.keystr(p): v.numpy()
                for p, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_got.keys() == flat_ref.keys()
    for k in flat_ref:
        np.testing.assert_array_equal(flat_got[k], flat_ref[k])
    # the port's own random tree has the JAX one's names and shapes
    mine = tcodec.init_arch_params(arch, seed=1, hidden=32, latent_dim=DIM)
    assert {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(mine)} == \
        {k: v.shape for k, v in flat_ref.items()}
    drop = tcodec.ARCH_SPECS[arch][-1][1] + ".weight"
    save_safetensors(path, {k: v for k, v in stored.items() if k != drop})
    with pytest.raises(tcodec.CodecMismatchError, match=re.escape(drop)):
        tcodec.load_from_checkpoint(SafetensorsFile(path), arch=arch)
    with pytest.raises(tcodec.CodecMismatchError, match="unknown codec.arch"):
        tcodec.load_from_checkpoint(SafetensorsFile(path), arch="vq_v9")


def _stub_lm(codes):
    """An LM planner that returns ``codes``, and records what it is asked to
    understand."""
    res = types.SimpleNamespace(metadata={"duration": 10, "bpm": 90}, candidates=None,
                                time_costs={"lm_phase2_time_cost": 0.0},
                                code_indices=np.asarray(codes, np.int32))
    lm = types.SimpleNamespace(seen=[])
    lm.generate_with_stop_condition = lambda *a, **k: res
    lm.understand_audio_from_codes = lambda codes, **kw: lm.seen.append(codes) or {"ok": 1}
    return lm


@pytest.fixture(scope="module")
def engines():
    dp, tp, vp = jax_params(seed=3, vae_affine_scale=0.1)
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    return jeng, teng


def test_generate_music_with_codec_hints(engines, monkeypatch):
    """The LM's 50 codes (10 s) become 250 frames of hints: the request turns
    into a cover whose src latents are the hints, as in the JAX package; with
    a source already given, or another task, the codes are not used."""
    jeng, teng = engines
    jp, tp = _codec("conv_v1", 5)
    codes = np.random.default_rng(6).integers(0, 64000, 50)
    seen = {}

    def capture(key, run=None):
        def generate(req, **kw):
            seen[key] = req
            if run is None:
                return types.SimpleNamespace(time_costs={}, sample_rate=48000, seeds=[0])
            return run(req, **kw)
        return generate

    monkeypatch.setattr(jeng, "generate", capture("jax"))
    monkeypatch.setattr(teng, "generate", capture("port", teng.generate))
    rng = np.random.default_rng(7)
    kw = dict(caption="x", duration=10.0, thinking=False,
              style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)))
    jinf.generate_music(jeng, _stub_lm(codes), jinf.GenerationParams(**kw), codec_params=jp)
    res = tinf.generate_music(teng, _stub_lm(codes), tinf.GenerationParams(**kw),
                              codec_params=tp)
    assert seen["port"].task == seen["jax"].task == "cover"
    hints = np.asarray(seen["jax"].src_latents)
    assert seen["port"].src_latents.shape == hints.shape == (1, 250, DIM)
    np.testing.assert_allclose(seen["port"].src_latents, hints, rtol=0,
                               atol=F32_REL_MAX * np.abs(hints).max())
    assert np.isfinite(res.audio).all() and res.pcm16().shape[1] == 250 * SLICE_VAE.hop_length
    tinf.generate_music(teng, _stub_lm(codes), tinf.GenerationParams(task_type="repaint", **kw),
                        codec_params=tp)
    assert seen["port"].task == "repaint" and seen["port"].src_latents is None
    tinf.generate_music(teng, _stub_lm(codes), tinf.GenerationParams(src_latents=hints * 0, **kw),
                        codec_params=tp)
    assert seen["port"].task == "text2music" and not seen["port"].src_latents.any()


def test_audio_to_codes_and_understand_audio(engines, seen_values):
    """A 4 s stereo waveform -> 20 codes through each package's VAE and the
    same codec: equal off the rounding edges; understand_audio hands them to
    the LM's understanding flow."""
    jeng, teng = engines
    jp, tp = _codec("conv_v1", 8)
    audio = (np.random.default_rng(9).standard_normal((100 * SLICE_VAE.hop_length + 3, 2))
             * 0.3).astype(np.float32)
    jlm, lm = _stub_lm([]), _stub_lm([])
    ref = jinf.understand_audio(jeng, jlm, jp, audio)
    values = seen_values[-1]
    got_str = tdb.audio_to_codes(teng, tp, audio)
    assert tinf.understand_audio(teng, lm, tp, audio) == ref == {"ok": 1}
    assert lm.seen == [got_str]
    ref_str = jlm.seen[0]

    def parse(s):
        return np.asarray([int(c) for c in s.replace("<|audio_code_", " ").replace("|>", "")
                           .split()])

    assert len(parse(got_str)) == 20
    _codes_equal_off_edge(parse(got_str)[None], parse(ref_str)[None], values)


def test_build_codec(tmp_path):
    from acestep_tpu_torch import loader

    assert tlaunch.build_codec(None) is None
    assert tlaunch.build_codec(str(tmp_path), device="cpu") is None
    _, tp = _codec("rfsq_conv", 10)
    loader.save_params(str(tmp_path / "codec"), tp)
    got = tlaunch.build_codec(str(tmp_path), device="cpu")
    assert tcodec.get_arch(got)[0] == "rfsq_conv"
    codes = torch.arange(10)[None]
    torch.testing.assert_close(tcodec.detokenize(got, codes), tcodec.detokenize(tp, codes),
                               rtol=0, atol=0)
