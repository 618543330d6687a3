"""The port's Trainer, datasets and dataset builder (acestep_tpu_torch.training)
on the CPU, against the JAX package where it has a counterpart.

Tolerances:
  * checkpoint / resume: bit for bit (the tensors are written as they are);
  * the exported adapter merged by the JAX package (``loader.load_params`` +
    ``apply_lora``, one f32 product) against the port's merge (the same
    product summed over the rank in order): 1e-6 of each kernel's peak, f32
    rounding;
  * a dataset built by the port's tiny engine against the JAX package's
    ``build_dataset`` on the same f32 weights: latents 1e-4 of the peak (f32
    convs), the condition 2e-2 (the text encoder and lyric encoder compute in
    bf16 in both packages; the JAX package's own eager and jitted conditions
    differ by up to a bf16 step of the peak), the context and masks exactly.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import loader as jloader
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.pipeline import AceStepEngine as JEngine
from acestep_tpu.training import data as jdata
from acestep_tpu.training import dataset_builder as jdb
from acestep_tpu.training import lora as jlora
from acestep_tpu_torch import loader, weights
from acestep_tpu_torch.pipeline import AceStepEngine as TEngine
from acestep_tpu_torch.training import data as tdata
from acestep_tpu_torch.training import dataset_builder as tdb
from acestep_tpu_torch.training import flow_matching as tfm
from acestep_tpu_torch.training.trainer import MetricsLogger, TrainConfig, Trainer
from tests.test_pipeline import TINY_DIT, TINY_TEXT, TINY_VAE
from tests.test_torch_models import _vae_params, port_cfg, to_np
from tests.test_torch_training import TINY, TTINY

LATENT_RTOL = 1e-4
COND_RTOL = 2e-2


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"latents": torch.from_numpy(rng.standard_normal((2, 8, 4)).astype(np.float32)),
               "context_latents": torch.from_numpy(
                   rng.standard_normal((2, 8, 8)).astype(np.float32)),
               "encoder_hidden_states": torch.from_numpy(
                   rng.standard_normal((2, 3, 32)).astype(np.float32)),
               "loss_mask": torch.ones((2, 8))}


@pytest.fixture(scope="module")
def base():
    return weights.from_jax_numpy(to_np(jdit.init_params(jax.random.key(0), TINY,
                                                         dtype=jnp.float32)))


def _tc(**kw):
    kw = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 20, "lora_rank": 2,
          "checkpoint_every": 4, "log_every": 100, **kw}
    return TrainConfig(**kw)


def _same_state(a: Trainer, b: Trainer) -> bool:
    leaves = (weights.tree_leaves(a.trainable) + weights.tree_leaves(a.opt_state.mu)
              + weights.tree_leaves(a.opt_state.nu))
    other = (weights.tree_leaves(b.trainable) + weights.tree_leaves(b.opt_state.mu)
             + weights.tree_leaves(b.opt_state.nu))
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and len(leaves) == len(other)
            and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(leaves, other)))


@pytest.mark.parametrize("mode", ["lora", "lokr", "full"])
def test_checkpoint_resume_bit_for_bit(mode, base, tmp_path):
    tr = Trainer(base, TTINY, _tc(mode=mode, lokr_factor=4), str(tmp_path), device="cpu")
    out = tr.train(_batches(8), max_steps=8, log_fn=lambda s: None)
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])
    ckpts = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("ckpt_") and d.is_dir())
    assert ckpts == ["ckpt_0000004", "ckpt_0000008"]
    tr2 = Trainer(base, TTINY, _tc(mode=mode, lokr_factor=4), str(tmp_path), device="cpu")
    assert tr2.resume()
    assert _same_state(tr, tr2) and tr2.history == tr.history
    # one more step from each, with the same draws: equal bit for bit
    batch = next(_batches(1, seed=9))
    t, noise = tfm.draw(torch.Generator().manual_seed(3), batch["latents"])
    a = tr.step_fn(tr.trainable, tr.opt_state, batch, t, noise)
    b = tr2.step_fn(tr2.trainable, tr2.opt_state, batch, t, noise)
    assert torch.equal(a[2], b[2])
    assert all(torch.equal(x, y) for x, y in zip(weights.tree_leaves(a[0]), weights.tree_leaves(b[0])))
    # an older checkpoint by step
    tr3 = Trainer(base, TTINY, _tc(mode=mode, lokr_factor=4), str(tmp_path), device="cpu")
    assert tr3.resume(step=4) and tr3.step == 4 and tr3.opt_state.count == 4


def test_train_config_is_the_jax_packages():
    from acestep_tpu.training.trainer import TrainConfig as JTrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


def test_resume_without_checkpoint_and_bad_mode(base, tmp_path):
    assert not Trainer(base, TTINY, _tc(), str(tmp_path), device="cpu").resume()
    with pytest.raises(ValueError, match="dora"):
        Trainer(base, TTINY, _tc(mode="dora"), str(tmp_path), device="cpu")


def test_export_merges_in_the_jax_package(base, tmp_path):
    tr = Trainer(base, TTINY, _tc(lr=5e-3, checkpoint_every=0), str(tmp_path), device="cpu")
    tr.train(_batches(4), max_steps=4, log_fn=lambda s: None)
    path = tr.export("adapter")
    jadapter = jloader.load_params(path)
    for got, ref in zip(weights.tree_leaves(tr.trainable), jax.tree_util.tree_leaves(jadapter)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    jbase = jdit.init_params(jax.random.key(0), TINY, dtype=jnp.float32)
    jmerged = jlora.apply_lora(jbase, jadapter, 16.0)
    merged = tr.merged_params()
    kernel = merged["layers"][0]["self_attn"]["q_proj"]["kernel"]
    assert not torch.equal(kernel, base["layers"][0]["self_attn"]["q_proj"]["kernel"])
    jf, tf = weights.flatten(to_np(jmerged)), weights.flatten(merged)
    for name, leaf in tf.items():
        ref = np.asarray(jf[name], np.float32)
        assert np.abs(leaf.numpy() - ref).max() <= 1e-6 * np.abs(ref).max(), name
    # the port's loader reads the export back the same
    back = loader.load_params(path)
    assert all(torch.equal(x, y) for x, y in zip(weights.tree_leaves(back),
                                                 weights.tree_leaves(tr.trainable)))


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "events.jsonl")
    m = MetricsLogger(path)
    for i in range(5):
        m.scalar("train/loss", 1.0 / (i + 1), i)
    m.flush()
    events = [json.loads(line) for line in open(path)]
    assert len(events) == 5
    assert events[0]["tag"] == "train/loss" and events[4]["step"] == 4
    assert events[2]["value"] == pytest.approx(1 / 3)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    rng = np.random.default_rng(0)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    dp = jdit.init_params(k1, TINY_DIT, dtype=jnp.float32, sampler=sampler)
    vp = _vae_params(k2, TINY_VAE, rng)
    tp = jqwen.init_params(k3, TINY_TEXT, dtype=jnp.float32, sampler=sampler)
    jeng = JEngine(dp, TINY_DIT, vp, TINY_VAE, tp, TINY_TEXT)
    teng = TEngine(weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
                   weights.from_jax_numpy(to_np(vp)), port_cfg(TINY_VAE),
                   weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    return jeng, teng


def _samples():
    rng = np.random.default_rng(0)
    hop = TINY_VAE.hop_length
    out = []
    for i, frames in enumerate((12, 9, 12)):
        s = {"audio": rng.standard_normal((frames * hop, 2)).astype(np.float32) * 0.1,
             "style_token_ids": rng.integers(0, 250, (1, 5 + i))}
        if i == 1:
            s["lyric_token_ids"] = rng.integers(0, 250, (1, 7))
        out.append(s)
    return out


def test_dataset_matches_jax_and_reads_across(engines, tmp_path):
    jeng, teng = engines
    jdir = jdata.build_dataset(jeng, _samples(), str(tmp_path / "jax"))
    tdir = tdata.build_dataset(teng, _samples(), str(tmp_path / "port"))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    jds, tds = jdata.PreprocessedDataset(jdir), tdata.PreprocessedDataset(tdir)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        a, b = jds.load(i), tds.load(i)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a["loss_mask"], b["loss_mask"])
        np.testing.assert_array_equal(a["encoder_attn_mask"], b["encoder_attn_mask"])
        np.testing.assert_allclose(b["context_latents"], a["context_latents"],
                                   atol=LATENT_RTOL * np.abs(a["context_latents"]).max())
        np.testing.assert_allclose(b["latents"], a["latents"],
                                   atol=LATENT_RTOL * np.abs(a["latents"]).max())
        ref = a["encoder_hidden_states"]
        np.testing.assert_allclose(b["encoder_hidden_states"], ref,
                                   atol=COND_RTOL * np.abs(ref).max())
    # each package reads the other's directory, in the same batch order
    jb = list(jdata.PreprocessedDataset(tdir).batches(batch_size=2, seed=3, epochs=2))
    tb = list(tdata.PreprocessedDataset(jdir).batches(batch_size=2, seed=3, epochs=2))
    own = list(jds.batches(batch_size=2, seed=3, epochs=2))
    assert len(jb) == len(tb) == len(own) == 4
    for x, y, z in zip(jb, tb, own):
        for k in z:
            np.testing.assert_array_equal(y[k].numpy(), np.asarray(z[k]))
            assert np.asarray(x[k]).shape == tuple(y[k].shape)
            if k in ("loss_mask", "encoder_attn_mask"):
                np.testing.assert_array_equal(np.asarray(x[k]), y[k].numpy())


def _write_wav(path, seconds, sr=8000, seed=0):
    from acestep_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(seed)
    write_wav(str(path), (rng.standard_normal((int(seconds * sr), 2)) * 0.1).astype(np.float32),
              sr)


def _tree_dir(tmp_path):
    d = tmp_path / "songs"
    (d / "sub").mkdir(parents=True)
    _write_wav(d / "a.wav", 1.0, seed=1)
    _write_wav(d / "b.wav", 0.5, seed=2)
    _write_wav(d / "sub" / "c.wav", 0.25, seed=3)
    from acestep_tpu_torch.utils.flac import write_flac

    write_flac(str(d / "d.flac"), (np.random.default_rng(4).standard_normal((3000, 2)) * 3000)
               .astype(np.int16), 8000)
    (d / "broken.wav").write_bytes(b"RIFFnope")
    (d / "a.txt").write_text("warm piano")
    (d / "b.lyrics").write_text("[verse]\nhello")
    (d / "metadata.csv").write_text("filename,caption,bpm,keyscale,genres\n"
                                    "b.wav,csv caption,120.0,C major,\n"
                                    "d.flac,,95,,jazz\n")
    return d


def test_scan_and_label_match_jax(tmp_path, monkeypatch):
    d = _tree_dir(tmp_path)
    js, ts = jdb.scan_directory(str(d)), tdb.scan_directory(str(d))
    assert [dataclasses.asdict(s) for s in ts] == [dataclasses.asdict(s) for s in js]
    assert [s.filename for s in ts] == ["a.wav", "b.wav", "d.flac", "c.wav"]
    with pytest.raises(FileNotFoundError):
        tdb.scan_directory(str(d / "missing"))

    class LM:
        def understand_audio_from_codes(self, codes):
            if codes == "len=3000":
                raise ValueError("unreadable")
            return {"bpm": 88, "keyscale": "D minor", "caption": f"lm {codes}",
                    "language": "en", "genres": "pop", "timesignature": "4"}

        def format_sample_from_input(self, text):
            return {"caption": "formatted"}

    def codes(engine, codec_params, audio):
        return f"len={audio.shape[0]}"

    monkeypatch.setattr(jdb, "audio_to_codes", codes)
    monkeypatch.setattr(tdb, "audio_to_codes", codes)
    jmsg, tmsg = [], []
    jl = jdb.label_all(js, None, LM(), None, progress_callback=jmsg.append, format_lyrics=True)
    tl = tdb.label_all(ts, None, LM(), None, progress_callback=tmsg.append, format_lyrics=True)
    assert [dataclasses.asdict(s) for s in tl] == [dataclasses.asdict(s) for s in jl]
    assert tmsg == jmsg and any(m.startswith("failed d.flac") for m in tmsg)
    assert [s.labeled for s in tl] == [True, True, False, True]
