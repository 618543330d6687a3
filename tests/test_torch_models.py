"""Port parity: models of acestep_tpu_torch (qwen, dit, vae) against the JAX
package on the same small-config parameters and inputs, on the CPU.

Parameters come from the JAX package's ``init_params`` + ``quantize_tree_jax``
(q8_0 on every 2-D kernel whose K allows it) and reach the port through
``weights.from_jax_numpy``; inputs are made from numpy seeds.

Tolerances, stated from the dtype: the bf16 models (text encoder, DiT) round
at every op, and XLA fuses some of those ops where PyTorch rounds each one (the
JAX package's own jitted and eager runs of the DiT step below differ by a few
bf16 steps at the output's peak).  They are held to cosine >= 0.9995 and a max abs error of
four bf16 steps at the peak (4 * 2^-7 of it); the f32 VAE to 1e-4 of its peak.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import sampler as jsampler
from acestep_tpu.config import VAEConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.models import vae as jvae
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.models import qwen as tqwen
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from tests.test_pipeline import TINY_DIT, TINY_TEXT

# a decoder with a 256-channel block and two 128-channel blocks, so decode
# reaches the fused res-unit and trio dispatch (TINY_VAE's 8 channels never do)
SLICE_VAE = VAEConfig(
    audio_channels=2, encoder_hidden_size=16, decoder_channels=128,
    decoder_input_channels=TINY_DIT.audio_acoustic_hidden_dim,
    downsampling_ratios=(2, 2, 2), channel_multiples=(1, 2, 4),
)

KERNEL_GAIN = 4.0
BF16_COS = 0.9995
BF16_REL_MAX = 4 * 2.0 ** -7
F32_REL_MAX = 1e-4


def port_cfg(cfg):
    """A JAX-package config dataclass -> the port's own class of the same name."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _quant_policy(path, arr):
    leaf = path.rsplit("/", 1)[-1]
    return (getattr(arr, "ndim", 0) == 2 and leaf == "kernel"
            and "embed_tokens" not in path and "norm" not in path)


def _scale_kernels(tree, s):
    """Scale every 2-D kernel so the tiny random models carry signal through
    their layers: at init's 0.02 and width 64 the DiT's velocity is ~0.16 of
    the noise; at x4 it is ~0.7 (the slice test's latents).  Much more makes the
    random chain chaotic: at x8 the JAX package's own jitted and eager runs of
    the slice disagree by more than the 26 dB waveform gate allows, while at
    x4 they agree with margin."""
    if isinstance(tree, dict):
        return {k: (v * s if k == "kernel" and v.ndim == 2 else _scale_kernels(v, s))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scale_kernels(v, s) for v in tree]
    return tree


def _vae_params(key, cfg, rng, affine_scale=0.0):
    """The JAX VAE's parameter tree (structure from ``vae.init_params``) filled
    with numpy draws: conv weights at init scale N(0, 1/(k*cin)); biases and
    log-scale Snake parameters are zero as in ``init_params`` unless
    ``affine_scale`` draws them too (so every term of a unit is exercised)."""
    shapes = jax.eval_shape(lambda k: jvae.init_params(k, cfg), key)

    def fill(path, leaf):
        name = path[-1].key
        if name == "w":
            k, cin = leaf.shape[0], leaf.shape[1]
            s = 1.0 / np.sqrt(k * cin)
        else:
            s = affine_scale
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * s)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_params(seed=0, vae_affine_scale=0.0):
    """(dit, text, vae) parameter trees of the JAX package, q8_0-quantized
    (``init_params`` with its numpy sampler, then ``quantize_tree_jax``)."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    rng = np.random.default_rng(seed)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    dp = quantize_tree_jax(_scale_kernels(jdit.init_params(k1, TINY_DIT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=_quant_policy)
    tp = quantize_tree_jax(_scale_kernels(jqwen.init_params(k3, TINY_TEXT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=_quant_policy)
    return dp, tp, _vae_params(k2, SLICE_VAE, rng, vae_affine_scale)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_bf16_close(got, ref):
    got = np.asarray(got, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref) + 1e-30)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
    assert cos >= BF16_COS and err <= BF16_REL_MAX, (cos, err)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def params():
    return jax_params(vae_affine_scale=0.1)


def test_qwen_forward(params):
    _, tp, _ = params
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_TEXT.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    fwd = jax.jit(lambda p, i, m: jqwen.forward(p, TINY_TEXT, i, m))
    ref = _f32(fwd(jqwen.stack_params(tp), jnp.asarray(ids), jnp.asarray(mask)))
    ttp = precast_quant_scales(tqwen.stack_params(weights.from_jax_numpy(to_np(tp))))
    got = tqwen.forward(ttp, port_cfg(TINY_TEXT), torch.from_numpy(ids).long(),
                        torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 12, TINY_TEXT.hidden_size)
    assert_bf16_close(got.float()[mask.astype(bool)], ref[mask.astype(bool)])


def test_dit_forward_one_step(params):
    dp, _, _ = params
    rng = np.random.default_rng(1)
    b, t, lc = 1, 20, 10
    cfg = TINY_DIT
    x = rng.standard_normal((b, t, cfg.audio_acoustic_hidden_dim)).astype(np.float32)
    ctx = rng.standard_normal((b, t, cfg.context_dim)).astype(np.float32)
    enc = rng.standard_normal((b, lc, cfg.hidden_size)).astype(np.float32)
    attn_mask = (np.arange(t)[None] < 17).astype(np.int32)
    enc_mask = (np.arange(lc)[None] < 7).astype(np.int32)
    ts = np.full((b,), 0.9, np.float32)

    @jax.jit
    def jax_step(p, x, ts, ctx, enc, attn_mask, enc_mask):
        kv = jdit.compute_all_cross_kv(p, cfg, jdit.compute_condition(p, cfg, enc))
        return jdit.forward(p, cfg, x, ts, ts, context_latents=ctx, attn_mask=attn_mask,
                            encoder_attn_mask=enc_mask, cross_kv_cache=kv)

    ref = _f32(jax_step(jdit.fuse_params(jdit.stack_params(dp)),
                        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ts), jnp.asarray(ctx),
                        jnp.asarray(enc, jnp.bfloat16), jnp.asarray(attn_mask),
                        jnp.asarray(enc_mask)))

    tp = precast_quant_scales(tdit.fuse_params(tdit.stack_params(
        weights.from_jax_numpy(to_np(dp)))))
    pcfg = port_cfg(cfg)
    tenc = tdit.compute_condition(tp, pcfg, torch.from_numpy(enc).bfloat16())
    got = tdit.forward(tp, pcfg, torch.from_numpy(x).bfloat16(), torch.from_numpy(ts),
                       torch.from_numpy(ts), torch.from_numpy(ctx),
                       tdit.compute_all_cross_kv(tp, pcfg, tenc),
                       attn_mask=torch.from_numpy(attn_mask),
                       encoder_attn_mask=torch.from_numpy(enc_mask))
    assert got.shape == ref.shape and "qkv_proj" in tp["layers"]["self_attn"]
    assert np.abs(ref).max() > 0.1
    assert_bf16_close(got.float(), ref)


def test_vae_decode(params):
    _, _, vp = params
    lat = np.random.default_rng(2).standard_normal((1, 6, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z: jvae.decode(p, SLICE_VAE, z))(vp, jnp.asarray(lat)))
    tvp = weights.from_jax_numpy(to_np(vp))
    got = tvae.decode(tvp, port_cfg(SLICE_VAE), torch.from_numpy(lat)).numpy()
    assert got.shape == (1, 6 * SLICE_VAE.hop_length, 2)
    np.testing.assert_allclose(got, ref, atol=F32_REL_MAX * np.abs(ref).max(), rtol=0)


def test_vae_silence_latents(params):
    _, _, vp = params
    ref = np.asarray(jvae.silence_latents(vp, SLICE_VAE, n_frames=8, chunk_frames=4))
    got = tvae.silence_latents(weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
                               n_frames=8, chunk_frames=4).numpy()
    assert got.shape == ref.shape == (1, 8, 8)
    np.testing.assert_allclose(got, ref, atol=F32_REL_MAX * np.abs(ref).max(), rtol=0)


def test_timestep_schedule():
    from acestep_tpu_torch import sampler as tsampler

    for shift in (1.0, 2.0, 3.0, 2.4):
        assert tsampler.get_timestep_schedule(shift) == jsampler.get_timestep_schedule(shift)
    custom = [0.97, 0.5, 0.31, 0.0]
    assert tsampler.get_timestep_schedule(3.0, custom) == \
        jsampler.get_timestep_schedule(3.0, custom)


@pytest.mark.parametrize("chunk", [4, 512])       # overlap-discard windows; one window
def test_tiled_decode_int16(params, chunk):
    """int16 at the global peak scale; f32 differences may move a sample by
    one step of the int16 rounding, never more."""
    _, _, vp = params
    lat = np.random.default_rng(3).standard_normal((1, 10, 8)).astype(np.float32)
    i16_ref, scale_ref = jax.jit(
        lambda p, z: jvae.fused_tiled_decode_int16(p, SLICE_VAE, z, chunk_frames=chunk)
    )(vp, jnp.asarray(lat))
    i16, scale = tvae.fused_tiled_decode_int16(
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE), torch.from_numpy(lat),
        chunk_frames=chunk)
    assert i16.dtype == torch.int16 and i16.shape == i16_ref.shape
    np.testing.assert_allclose(float(scale), float(scale_ref), rtol=1e-5)
    diff = np.abs(i16.numpy().astype(np.int32) - np.asarray(i16_ref).astype(np.int32))
    assert diff.max() <= 1
