"""The port's train_quality_eval (acestep_tpu_torch/train_quality_eval.py)
against the JAX package's tools/train_quality_eval.py on the CPU, at small
configs (the JAX tool's ``_configs`` monkeypatched; nothing under tools/ is
edited): the shared pieces, phase vae and the tool end to end on the CPU.
Phase eval's parity is in test_torch_quant_eval.py.

The JAX tool draws its initial weights from ``jax.random`` keys; the port's
phases take them as arguments, so each test gives the port the JAX tool's
own draws (its ``init_params`` given numpy draws of the same structure
and scales).

Tolerances:
  * ``synth_song``: bit for bit (the same numpy draws in the same order);
  * ``stft_logmag``: the symmetric Hann window within 3e-7 of
    ``jnp.hanning`` (measured 2.4e-7, two f32 ulps near 1: XLA's cosine is
    not correctly rounded; torch's periodic default is off by 1.5e-4); the
    magnitudes within 1e-6 of the peak magnitude (two f32 FFT libraries;
    measured 3.8e-7) and the log-magnitudes' mean absolute difference, which
    the loss averages, within 1e-5 (measured 3.5e-7; a bin near zero
    magnifies its log's difference: 1.8e-3 at one bin of 6.6e-5);
  * ``AdamW(end_value=...)`` against optax's chain: 1e-6 of each leaf's peak
    per step (test_torch_training's optimizer bound); at ``end_value=0`` the
    schedule is bit for bit the pre-end_value formula;
  * two VAE steps: the losses within 1e-4 relative (measured 1.3e-6), and
    the update of the saved params (params minus the initial ones) per leaf
    within UPDATE_TOL of the JAX update's norm (norm of the difference;
    test_torch_training's bound: an element whose two gradients nearly
    cancel moves by +-lr either way under Adam; measured 5.9e-3); the
    held-out spectral L1 within 1e-3 relative (measured 3e-7).
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acestep_tpu import loader as jloader
from acestep_tpu.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu.models import vae as jvae
from acestep_tpu_torch import loader as tloader
from acestep_tpu_torch import train_quality_eval as ttqe
from acestep_tpu_torch import weights
from acestep_tpu_torch.training.flow_matching import AdamW
from tests.test_torch_models import _vae_params, port_cfg, to_np
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the smallest configs at which every 4-bit format keeps its kernels (K % 256
# == 0, >= 64 Ki elements: q, k and v all quantized, so the JAX engine can
# fuse them) and the VAE keeps hop 32 at 800 Hz
DIT = DiTConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=1,
    num_attention_heads=4, num_key_value_heads=4, head_dim=64,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=8, text_hidden_dim=64,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=8,
)
VAE = VAEConfig(encoder_hidden_size=16, decoder_channels=8, decoder_input_channels=8,
                downsampling_ratios=(2, 4, 4), channel_multiples=(1, 2, 4),
                sampling_rate=800)
TEXT = QwenConfig(vocab_size=512, hidden_size=64, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=1, intermediate_size=128,
                  head_dim=32)
CFGS = (DIT, VAE, TEXT)
OPT_RTOL = 1e-6
WINDOW_ATOL = 3e-7
STFT_MAG_RTOL = 1e-6
STFT_LOG_MEAN_ATOL = 1e-5
LOSS_RTOL = 1e-4
UPDATE_TOL = 0.0776            # test_torch_training's UPDATE_TOL


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_train_quality_eval",
                                                  REPO / "tools" / "train_quality_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTQE = _jax_tool()


def _to_port(tree):
    return weights.from_jax_numpy(to_np(tree))


@pytest.mark.parametrize("seed", [42, 99, 3])
def test_synth_song_bit_equal(seed):
    ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a, b = JTQE.synth_song(ra), ttqe.synth_song(rb)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (8000, 2)
        np.testing.assert_array_equal(a, b)
    assert ra.integers(0, 1 << 30) == rb.integers(0, 1 << 30)     # same draws used


def test_configs_and_constants_match_jax():
    for a, b in zip(JTQE._configs(), ttqe.configs()):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in ("HALF_DIT", "HALF_VAE", "HALF_TEXT", "N_SONGS", "SONG_S", "SR", "HOP"):
        assert getattr(JTQE, name) == getattr(ttqe, name), name


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_stft_logmag(x, nfft, hop):
    """tools/train_quality_eval.py:136-144 (nested in phase_vae there)."""
    b, l, c = x.shape
    x = jnp.moveaxis(x, -1, 1).reshape(b * c, l)
    n_frames = (l - nfft) // hop + 1
    idx = hop * jnp.arange(n_frames)[:, None] + jnp.arange(nfft)[None, :]
    seg = x[:, idx] * jnp.hanning(nfft)
    return jnp.log(jnp.abs(jnp.fft.rfft(seg, axis=-1)) + 1e-5)


def test_stft_logmag_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 2048, 2)).astype(np.float32) * 0.3
    for nfft, hop in ttqe.FFTS:
        win = torch.hann_window(nfft, periodic=False, dtype=torch.float32).numpy()
        assert np.abs(win - np.asarray(jnp.hanning(nfft))).max() <= WINDOW_ATOL
        ref = np.asarray(_jax_stft_logmag(jnp.asarray(x), nfft, hop))
        got = ttqe.stft_logmag(torch.from_numpy(x), nfft, hop).numpy()
        assert got.shape == ref.shape
        mag_err = np.abs(np.exp(got) - np.exp(ref)).max() / np.exp(ref).max()
        assert mag_err <= STFT_MAG_RTOL, (nfft, mag_err)
        assert np.abs(got - ref).mean() <= STFT_LOG_MEAN_ATOL, (nfft, np.abs(got - ref).mean())


@pytest.mark.parametrize("end_value", [0.0, 1e-6])
def test_adamw_end_value_matches_optax(end_value):
    """The VAE phase's optimizer (train_quality_eval.py:172-177) step by step."""
    rng = np.random.default_rng(1)
    shapes = {"w": (5, 7), "b": (7,), "deep": [{"k": (3, 4)}]}
    jp = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32),
                                shapes, is_leaf=lambda x: isinstance(x, tuple))
    steps = 8
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 2e-4, 2, steps, end_value), weight_decay=1e-5))
    topt = AdamW(lr=2e-4, weight_decay=1e-5, warmup_steps=2, total_steps=steps,
                 clip_norm=0.5, end_value=end_value)
    js, tp = opt.init(jp), _to_port(jp)
    update = jax.jit(opt.update)
    ts = topt.init(tp)
    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-4, 2, steps, end_value)
    for step in range(steps + 2):
        jg = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), jp)
        upd, js = update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = weights.tree_leaves(_to_port(jg))
        new, ts = topt.apply(weights.tree_leaves(tp), tg, ts, float(topt.global_norm(tg)))
        tp = weights.tree_unflatten(tp, new)
        assert topt.schedule(step) == pytest.approx(float(sched(step)), rel=1e-6)
        for got, ref in zip(weights.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= OPT_RTOL * np.abs(ref).max()
    # the end of the decay is end_value (optax: alpha * peak)
    assert topt.schedule(steps) == pytest.approx(end_value, abs=1e-12)


def test_adamw_end_value_zero_is_the_plain_cosine():
    """At end_value 0 the schedule is bit for bit ``f32(lr) * cosine``, the
    formula before end_value existed."""
    f = np.float32
    for lr, warmup, total in ((2e-4, 300, 3000), (3e-4, 200, 4000), (1e-4, 1, 2)):
        opt = AdamW(lr=lr, warmup_steps=warmup, total_steps=total)
        for count in range(warmup, total + 3, 7):
            decay = f(total - warmup)
            c = min(f(count - warmup), decay)
            cos = f(0.5) * (f(1) + f(np.cos(f(np.pi) * c / decay)))
            assert opt.schedule(count) == float(np.float32(f(lr) * cos))


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    """The JAX tool's phase_vae(out, steps=2, batch=2) at the small VAE, and
    the port's phase_vae from the same initial params."""
    out_j = str(tmp_path_factory.mktemp("jax_vae"))
    out_t = str(tmp_path_factory.mktemp("port_vae"))
    # the initial params: numpy draws in init_params' structure and scales
    # (its eager jax.random draws are the slowest compile of the test)
    p0 = _vae_params(jax.random.key(7), VAE, np.random.default_rng(7))
    mp = pytest.MonkeyPatch()
    mp.setattr(JTQE, "_configs", lambda: CFGS)
    mp.setattr(jvae, "init_params", lambda key, cfg, dtype=jnp.float32: p0)
    # the held-out recon on a jitted encode / decode (the tool runs them
    # eagerly: op by op, slower to compile; the saved params do not depend on it)
    mp.setattr(jvae, "encode", jax.jit(jvae.encode, static_argnums=1))
    mp.setattr(jvae, "decode", jax.jit(jvae.decode, static_argnums=1))
    try:
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            JTQE.phase_vae(out_j, steps=2, batch=2)
        logs = buf.getvalue().splitlines()
    finally:
        mp.undo()
    port = ttqe.phase_vae(out_t, 2, 2, vae_cfg=port_cfg(VAE), params=_to_port(p0),
                          device="cpu", log=lambda m: None)
    return out_j, out_t, p0, port, logs


def test_phase_vae_two_steps_match_jax(vae_runs):
    out_j, out_t, p0, port, logs = vae_runs
    jax_losses = [float(m.group(1)) for m in
                  (re.search(r"\[vae\] step \d+: loss ([0-9.e+-]+)", line) for line in logs) if m]
    assert len(jax_losses) == 2 and [r["step"] for r in port["losses"]] == [0, 1]
    for got, ref in zip([r["loss"] for r in port["losses"]], jax_losses):
        assert abs(got - ref) <= LOSS_RTOL * abs(ref), (got, ref)
    ref = weights.flatten(to_np(jloader.load_params(os.path.join(out_j, "vae_trained"))))
    got = weights.flatten(tloader.load_params(os.path.join(out_t, "vae_trained")))
    init = weights.flatten(to_np(p0))
    assert sorted(ref) == sorted(got) == sorted(init)
    moved = 0
    for name, p in init.items():
        p = np.asarray(p, np.float32)
        upd_ref = np.asarray(ref[name], np.float32) - p
        upd_got = got[name].numpy() - p
        norm = float(np.linalg.norm(upd_ref))
        moved += norm > 0
        err = float(np.linalg.norm(upd_got - upd_ref))
        assert err <= UPDATE_TOL * norm or err == 0.0, (name, err, norm)
    assert moved == len(init)           # no best-snapshot restore: both stepped
    with open(os.path.join(out_j, "vae_trained_meta.json")) as f:
        jmeta = json.load(f)
    assert port["spectral_recon_logmag_l1"] == pytest.approx(
        jmeta["spectral_recon_logmag_l1"], rel=1e-3)


def test_main_runs_every_phase_on_the_cpu(tmp_path, monkeypatch):
    """``python -m acestep_tpu_torch.train_quality_eval --phase all --device
    cpu`` at the small configs and a reduced schedule, then phases vae, data
    and train again: they resume (vae and data skipped, train at its last
    step, no new checkpoint)."""
    monkeypatch.setattr(ttqe, "configs", lambda: tuple(port_cfg(c) for c in CFGS))
    out = str(tmp_path / "tq")
    argv = ["--phase", "all", "--out", out, "--device", "cpu", "--vae-steps", "3",
            "--vae-batch", "2", "--steps", "3", "--batch-size", "2", "--songs", "2"]
    assert ttqe.main(argv) == 0
    with open(os.path.join(out, "report", "summary.json")) as f:
        first = json.load(f)
    assert first["vae_trained"] and len(first["rows"]) == 5
    assert len(first["decoder_control"]) == 2
    assert all(np.isfinite(v) for r in first["rows"][1:] for v in r["metrics"].values())
    with open(os.path.join(out, "dataset", "manifest.json")) as f:
        assert json.load(f)["count"] == 2
    stamp = os.path.getmtime(os.path.join(out, "vae_trained.safetensors"))
    for phase in ("vae", "data", "train"):
        assert ttqe.main(argv[:1] + [phase] + argv[2:]) == 0
    assert os.path.getmtime(os.path.join(out, "vae_trained.safetensors")) == stamp
    assert sorted(d for d in os.listdir(os.path.join(out, "train"))
                  if d.startswith("ckpt_") and not d.endswith(".json")) == ["ckpt_0000003"]
