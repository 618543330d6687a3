"""The port's CLI (``python -m acestep_tpu_torch.cli``) and its layered
settings on the CPU: every mode at a tiny random engine (monkeypatched in as
tests/test_cli.py does for the root CLI), token files, the wizard, and
Settings' order (override > environment > .env > default) as
tests/test_settings.py checks the JAX package's."""

import json
import os

import numpy as np
import pytest
import torch

from acestep_tpu_torch import cli as tcli
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import settings as tsettings
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.utils.audio import read_wav

DIT = DiTConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16, in_channels=24,
                audio_acoustic_hidden_dim=8, patch_size=2, sliding_window=8,
                text_hidden_dim=32, num_lyric_encoder_hidden_layers=0,
                num_timbre_encoder_hidden_layers=0, timbre_hidden_dim=8)
VAE = VAEConfig(audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
                decoder_input_channels=8, downsampling_ratios=(2, 4, 4),
                channel_multiples=(1, 2, 4))
TEXT = QwenConfig(vocab_size=151000 + 1024, hidden_size=32, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=2, intermediate_size=64,
                  head_dim=16)


@pytest.fixture
def tiny(monkeypatch):
    """build_random_engine replaced by a tiny f32 engine on the CPU; the calls'
    arguments recorded."""
    calls = []
    real = tpipeline.build_random_engine

    def build(device=None, quant="q8_0", seed=0, **kw):
        calls.append({"device": device, "quant": quant, **kw})
        return real(device="cpu", quant=None, seed=seed, dit_cfg=DIT, vae_cfg=VAE,
                    text_cfg=TEXT)

    monkeypatch.setattr(tpipeline, "build_random_engine", build)
    for env, _t, _d in tsettings.KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    monkeypatch.chdir(os.path.dirname(__file__))     # no .env of the working tree
    return calls


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["--pipeline", "--pipeline-style-lyric",
                                  "--pipeline-style-lyric-timbre"])
def test_pipeline_modes(mode, tiny, tmp_path, capsys):
    out = tmp_path / "o.wav"
    assert tcli.main([mode, "--audio-seconds", "10", "--out", str(out), "--device", "cpu",
                      "--timbre-rand-n", "2"]) == 0
    info = _last_json(capsys)
    audio, sr = read_wav(str(out))
    assert info["mode"] == "pipeline" and info["seeds"] == [0]
    assert sr == 48000 and audio.shape == (info["samples"], 2) == (250 * VAE.hop_length, 2)
    assert "total_time_cost" in info["time_costs"]
    assert tiny == [{"device": "cpu", "quant": "q8_0", "dit_mega": False, "int8_act": False}]


def test_token_files_and_switches(tiny, tmp_path, capsys, monkeypatch):
    style, lyric = tmp_path / "style.txt", tmp_path / "lyric.txt"
    style.write_text("1 2 3\n4 5")
    lyric.write_text(" ".join(str(i) for i in range(40)))
    assert tcli._read_token_file(str(style)).tolist() == [[1, 2, 3, 4, 5]]
    monkeypatch.setenv("ACESTEP_TPU_QUANT", "q4_k")
    monkeypatch.setenv("ACESTEP_TPU_INT8_ACT", "1")
    out = tmp_path / "o.wav"
    assert tcli.main(["--pipeline-style-lyric", "--style-tokens", str(style),
                      "--lyric-tokens", str(lyric), "--audio-seconds", "1", "--out", str(out),
                      "--device", "cpu", "--seed", "5"]) == 0
    assert _last_json(capsys)["seeds"] == [5]
    assert tiny[-1] == {"device": "cpu", "quant": "q4_k", "dit_mega": False, "int8_act": True}
    monkeypatch.setenv("ACESTEP_TPU_DIT_MEGA", "yes")
    assert tcli.main(["--pipeline", "--audio-seconds", "1", "--out", str(out), "--device",
                      "cpu", "--quant", "bf16"]) == 0
    assert tiny[-1]["quant"] is None and tiny[-1]["dit_mega"] is True


def test_text_encoder_dit_and_vae_modes(tiny, tmp_path, capsys):
    assert tcli.main(["--text-encoder", "--device", "cpu"]) == 0
    info = _last_json(capsys)
    assert info["mode"] == "text-encoder" and info["shape"] == [1, 64, DIT.hidden_size]
    assert np.isfinite(info["mean"]) and info["std"] > 0
    assert tcli.main(["--dit", "--audio-seconds", "1", "--device", "cpu"]) == 0
    info = _last_json(capsys)
    assert info["mode"] == "dit" and info["frames"] == 25 and info["forward_s"] >= 0
    out = tmp_path / "v.wav"
    assert tcli.main(["--vae", "--audio-seconds", "1", "--out", str(out), "--device",
                      "cpu"]) == 0
    info = _last_json(capsys)
    audio, _ = read_wav(str(out))
    assert info["samples"] == audio.shape[0] == 25 * VAE.hop_length


def test_wizard(tiny, tmp_path, capsys, monkeypatch):
    answers = iter(["lofi beats", "", "n", "10", "7", str(tmp_path / "w.wav"), "q8_0"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    assert tcli.main(["--wizard", "--device", "cpu"]) == 0
    info = _last_json(capsys)
    assert info["seeds"] == [7] and info["out"] == str(tmp_path / "w.wav")
    assert read_wav(str(tmp_path / "w.wav"))[0].shape[0] == 250 * VAE.hop_length


def test_edit_formatted_prompt(tmp_path):
    editor = tmp_path / "ed.sh"
    editor.write_text("#!/bin/sh\nprintf '# caption\\nnew words\\n# lyrics\\nla la\\n' > \"$1\"\n")
    editor.chmod(0o755)
    assert tcli.edit_formatted_prompt("old", "x", editor=str(editor)) == ("new words", "la la")
    assert tcli.edit_formatted_prompt("old", "x", editor="false") == ("old", "x")


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--pipeline"])


def test_settings_layering(tmp_path, monkeypatch):
    for env, _t, _d in tsettings.KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    envf = tmp_path / ".env"
    envf.write_text("ACESTEP_TPU_QUANT=q4_k\nACESTEP_TPU_DIT_MEGA=1\n# c\nACESTEP_TPU_INT8_ACT=yes\n")
    monkeypatch.setenv("ACESTEP_TPU_INT8_ACT", "0")                 # env beats .env
    s = tsettings.Settings.load(env_file=str(envf))
    assert s.quant == "q4_k" and s.sources["quant"] == str(envf)
    assert s.dit_mega is True and s.int8_act is False and s.sources["int8_act"] == "env"
    s2 = tsettings.Settings.load(env_file=str(envf), quant="q8_0", dit_mega=None)
    assert s2.quant == "q8_0" and s2.sources["quant"] == "override"
    assert s2.sources["dit_mega"] == str(envf)
    with pytest.raises(ValueError, match="unknown setting"):
        tsettings.Settings.load(env_file=str(envf), qmm_backend="xla")
    with pytest.raises(AttributeError):
        s.sampler_mode


def test_settings_describe(tmp_path, monkeypatch):
    for env, _t, _d in tsettings.KNOBS.values():
        monkeypatch.delenv(env, raising=False)
    s = tsettings.Settings.load(env_file=str(tmp_path / "none.env"), int8_act=True)
    assert s.int8_act is True and s.sources["int8_act"] == "override"
    assert s.quant == "q8_0" and s.sources["quant"] == "default"
    text = s.describe()
    assert all(k in text for k in tsettings.KNOBS)
    # only the knobs the CLI reads: no JAX-only or environment-read switch
    assert set(tsettings.KNOBS) == {"quant", "dit_mega", "int8_act"}
