"""The port's host modules against the JAX package's: ``eval_metrics`` (the
same numbers on seeded numpy inputs), ``roofline`` (the same byte and FLOP
counts for the configs of tests/test_roofline.py, the weight bytes on the same
stacked trees carried across with ``weights.from_jax_numpy``, a DiT step's
by a deliberate difference; the peaks are the H100's alone, and an unknown
card raises)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import eval_metrics as jmetrics
from acestep_tpu import roofline as jroof
from acestep_tpu.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import eval_metrics as tmetrics
from acestep_tpu_torch import roofline as troof
from acestep_tpu_torch import weights
from acestep_tpu_torch.memory_planner import tree_bytes
from acestep_tpu_torch.models.stacking import unstack_layer_params

SMALL_DIT = DiTConfig(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=8,
)
SMALL_LM = QwenConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=128, head_dim=16)


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _to_port(tree):
    return weights.from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("shape", [(48000,), (48000, 2), (1000,)])
def test_eval_metrics_equal_the_jax_module(shape):
    rng = np.random.default_rng(len(shape))
    ref = rng.standard_normal(shape)
    test = ref + 0.05 * rng.standard_normal(shape)
    short = test[: shape[0] - 7]                      # _align cuts to the shorter
    for a, b in ((ref, test), (ref, short), (ref, ref)):
        assert tmetrics.waveform_metrics(a, b) == jmetrics.waveform_metrics(a, b)
        for fn in ("mae", "rmse", "cosine", "snr_db"):
            assert getattr(tmetrics, fn)(a, b) == getattr(jmetrics, fn)(a, b), fn
    lat = rng.standard_normal((1, 50, 64)).astype(np.float32)
    lat2 = lat + 1e-3 * rng.standard_normal(lat.shape).astype(np.float32)
    assert tmetrics.latent_metrics(lat, lat2) == jmetrics.latent_metrics(lat, lat2)
    mono = ref.mean(axis=-1) if ref.ndim == 2 else ref
    assert tmetrics.lsd(mono, mono * 0.9, n_fft=512, hop=128) == \
        jmetrics.lsd(mono, mono * 0.9, n_fft=512, hop=128)


def _hand_step_bytes(c, dtype_bytes=4):
    """The decoder's per-step weights of an unquantized tree, from the config."""
    h, i, hd, ps = c.hidden_size, c.intermediate_size, c.head_dim, c.patch_size
    q, kv, a = c.num_attention_heads * hd, c.num_key_value_heads * hd, c.audio_acoustic_hidden_dim
    layer = (2 * h * q + 2 * h * kv + 2 * hd      # self-attention q, k, v, o, q / k norms
             + 2 * h * q + hd                     # cross-attention q, o, q norm
             + 3 * h * i + 3 * h + 6 * h)         # mlp, three norms, scale-shift table
    temb = 256 * h + h + h * h + h + h * 6 * h + 6 * h   # linear_1, linear_2, time_proj
    rest = ps * c.in_channels * h + h + h * ps * a + a + h + 2 * h   # proj in / out, norm
    return dtype_bytes * (c.num_hidden_layers * layer + 2 * temb + rest)


@pytest.mark.parametrize("quant", [None, "q8_0"])
def test_weight_bytes_equal_the_jax_counts(quant):
    """Tree and LM bytes equal the JAX counts; a DiT step's weight bytes are
    the JAX count less what a request computes once (the lyric and timbre
    encoders, the condition embedder, the cross-attention's K/V), which the
    JAX count takes in, and equal a hand count of the decoder."""
    params = jdit.init_params(jax.random.key(0), SMALL_DIT, dtype=jnp.float32)
    if quant:
        params = quantize_tree_jax(params, quant)
    params = jdit.stack_params(params)
    port = _to_port(params)
    assert tree_bytes(port) == jroof.tree_quant_bytes(params)
    once = sum(tree_bytes(v) for k, v in port.items()
               if k.startswith(("lyric_", "timbre_")) or k == "condition_embedder")
    once += sum(tree_bytes(port["layers"]["cross_attn"][k]) for k in ("k_proj", "v_proj",
                                                                      "k_norm"))
    assert troof.dit_step_weight_bytes(port) == jroof.dit_step_weight_bytes(params) - once
    if quant is None:
        assert troof.dit_step_weight_bytes(port) == _hand_step_bytes(SMALL_DIT)
    assert 0 < troof.dit_step_weight_bytes(port) < tree_bytes(port)
    unstacked = dict(port, layers=unstack_layer_params(port["layers"]))
    assert troof.dit_step_weight_bytes(unstacked) == troof.dit_step_weight_bytes(port)


def test_flop_and_activation_counts_equal_the_jax_counts():
    for cfg in (DiTConfig(), SMALL_DIT):
        for frames, cond, batch in ((256, 320, 1), (512, 320, 1), (1536, 320, 2)):
            assert troof.dit_step_flops(_port(cfg), frames, cond, batch) == \
                jroof.dit_step_flops(cfg, frames, cond, batch)
    for frames in (100, 200, 1500):
        vc = VAEConfig()
        assert list(troof._vae_decoder_layers(_port(vc), frames)) == \
            list(jroof._vae_decoder_layers(vc, frames))
        assert troof.vae_decode_flops(_port(vc), frames, 2) == jroof.vae_decode_flops(vc, frames, 2)
        assert troof.vae_decode_act_bytes(_port(vc), frames) == \
            jroof.vae_decode_act_bytes(vc, frames)


def test_lm_decode_bytes_equal_the_jax_count():
    params = jqwen.stack_params(quantize_tree_jax(
        jqwen.init_params(jax.random.key(0), SMALL_LM, dtype=jnp.bfloat16), "q8_0"))
    port = _to_port(params)
    for cache_len, batch in ((128, 1), (256, 1), (1408, 4)):
        assert troof.lm_decode_bytes(port, _port(SMALL_LM), cache_len, batch) == \
            jroof.lm_decode_bytes(params, SMALL_LM, cache_len, batch)


def test_detect_chip_knows_the_h100_alone(monkeypatch):
    assert set(troof.CHIP_PEAKS) == {"h100"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        troof.detect_chip()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert troof.detect_chip() == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no peaks for"):
        troof.detect_chip()


def test_roofline_point_summary():
    s = troof.RooflinePoint(phase="x", time_s=0.001, bytes_=3.35e9, flops=989e9 / 2,
                            chip="h100").summary()
    assert abs(s["pct_hbm_roof"] - 100.0) < 0.05 and abs(s["pct_bf16_roof"] - 50.0) < 0.05
    assert s["bound_by"] == "bytes" and abs(s["bound_ms"] - 1.0) < 1e-6
    assert troof.bound_s(0.0, 989e12, "h100") == (1.0, "operations")
