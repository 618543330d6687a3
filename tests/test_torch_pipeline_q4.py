"""Port parity of the text2music slice at 4-bit weights (q4_0, q4_k) against
the JAX package, on the CPU, and of the VAE's multi-window int16 decode.

The models are 256 wide (intermediate 512, 2 layers, head_dim 64), so that
``supported_format_for`` keeps the 4-bit formats (K % 256 == 0): at the
64-wide TINY configs every 4-bit kernel would quietly fall back to q8_0.  Both
packages run the same quantized weights (``quantize_tree_jax``, carried across
with ``weights.from_jax_numpy``), so the slice is held to the Q8_0 gate of
docs/BENCHMARK.md:25-29 whatever the bit width: the int16 waveform at cosine
>= 0.999 and SNR >= 26 dB against the JAX chain (acestep_tpu.eval_metrics).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig, QwenConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.models import vae as jvae
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import vae as tvae
from tests.test_torch_models import (
    SLICE_VAE,
    _quant_policy,
    _scale_kernels,
    _vae_params,
    port_cfg,
    to_np,
)

Q4_DIT = DiTConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=8, text_hidden_dim=256,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=8,
)
Q4_TEXT = QwenConfig(
    vocab_size=256, hidden_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
    head_dim=64,
)
# the kernels' gain: the 64-wide slice test runs at x4 (test_torch_models.
# _scale_kernels); at 4x the width the same signal needs half the gain
KERNEL_GAIN = 2.0
GATE_COSINE = 0.999
GATE_SNR_DB = 26.0


def jax_q4_params(fmt, seed=0):
    """(dit, text, vae) parameter trees of the JAX package at the 256-wide
    configs, every 2-D kernel quantized to ``fmt`` where K allows it."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    rng = np.random.default_rng(seed)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    dp = quantize_tree_jax(_scale_kernels(jdit.init_params(k1, Q4_DIT, sampler=sampler),
                                          KERNEL_GAIN), fmt, policy=_quant_policy)
    tp = quantize_tree_jax(_scale_kernels(jqwen.init_params(k3, Q4_TEXT, sampler=sampler),
                                          KERNEL_GAIN), fmt, policy=_quant_policy)
    return dp, tp, _vae_params(k2, SLICE_VAE, rng)


def quant_formats(tree):
    """Count of quantized leaves by format."""
    out = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif hasattr(t, "fmt"):
            out[t.fmt] = out.get(t.fmt, 0) + 1

    walk(tree)
    return out


def request(cls, seed=5):
    rng = np.random.default_rng(seed)
    return cls(duration_s=10.0,
               style_token_ids=rng.integers(0, Q4_TEXT.vocab_size, (1, 20)),
               lyric_token_ids=rng.integers(0, Q4_TEXT.vocab_size, (1, 40)),
               seeds=[1])


def port_engine(dp, tp, vp):
    return tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(Q4_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(Q4_TEXT), device="cpu")


@pytest.mark.parametrize("fmt", ["q4_0", "q4_k"])
def test_whole_slice_4bit_int16_gate(fmt):
    dp, tp, vp = jax_q4_params(fmt, seed=3)
    teng = port_engine(dp, tp, vp)
    # the converted trees really carry 4-bit weights: decoder layers (stacked and
    # fused), lyric encoder and text encoder
    layers = teng.dit_params["layers"]
    assert layers["self_attn"]["qkv_proj"]["kernel"].fmt == fmt
    assert layers["mlp"]["gateup_proj"]["kernel"].fmt == fmt
    assert layers["mlp"]["down_proj"]["kernel"].fmt == fmt
    assert set(quant_formats(teng.dit_params["lyric_layers"])) == {fmt}
    assert set(quant_formats(teng.text_params)) == {fmt}

    t_valid = jpipeline.frames_for_duration(10.0)
    t = jpipeline.bucket_frames(t_valid)
    noise = np.random.default_rng(4).standard_normal(
        (1, t, Q4_DIT.audio_acoustic_hidden_dim)).astype(np.float32)
    jeng = jpipeline.AceStepEngine(dp, Q4_DIT, vp, SLICE_VAE, tp, Q4_TEXT)
    jreq = request(jpipeline.GenerationRequest)
    enc, enc_mask = jeng.build_condition(jreq, 1)
    ctx = jeng.build_context_latents(jreq, 1, t, t_valid)
    attn_mask = (jnp.arange(t)[None, :] < t_valid).astype(jnp.int32)
    lat = jsampler.sample_latents(
        jeng.dit_params, Q4_DIT, jnp.asarray(noise), ctx, enc, enc_mask,
        jsampler.get_timestep_schedule(3.0), attn_mask=attn_mask, use_attn_mask=True)
    i16_ref, scale_ref = jvae.fused_tiled_decode_int16(vp, SLICE_VAE, lat[:, :t_valid],
                                                       chunk_frames=512)
    ref = np.asarray(i16_ref).reshape(1, -1, 2).astype(np.float32) / float(scale_ref)

    res = teng.generate(request(tpipeline.GenerationRequest), noise=torch.from_numpy(noise))
    assert res.audio_i16.shape == (1, t_valid * SLICE_VAE.hop_length, 2)
    got = res.audio
    assert np.abs(ref).std() > 0
    cos = eval_metrics.cosine(ref, got)
    snr = eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def test_multi_window_decode_int16():
    """Seven overlap-discard windows (64 latent frames, overlap 16, stride 32)
    over 200 frames, as the 60 s path decodes four; f32 differences may move a
    sample by one step of the int16 rounding, never more."""
    vp = _vae_params(jax.random.key(1), SLICE_VAE, np.random.default_rng(1), 0.1)
    lat = np.random.default_rng(2).standard_normal((1, 200, 8)).astype(np.float32)
    i16_ref, scale_ref = jax.jit(
        lambda p, z: jvae.fused_tiled_decode_int16(p, SLICE_VAE, z, chunk_frames=64)
    )(vp, jnp.asarray(lat))
    i16, scale = tvae.fused_tiled_decode_int16(
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE), torch.from_numpy(lat),
        chunk_frames=64)
    assert len(tvae._window_plan(200, 64, None)) == 7
    assert i16.shape == i16_ref.shape == (200 * SLICE_VAE.hop_length * 2,)
    np.testing.assert_allclose(float(scale), float(scale_ref), rtol=1e-5)
    diff = np.abs(i16.numpy().astype(np.int32) - np.asarray(i16_ref).astype(np.int32))
    assert diff.max() <= 1
