"""Port parity of the LoRA merge (acestep_tpu_torch.training.lora) and the
run-time adapter manager (acestep_tpu_torch.lora_runtime) against the JAX
package, on the CPU.

Bounds, from what the two merges compute:
  * bf16 kernels: ``W + (alpha / r) * a @ b`` in f32, rounded once; the two
    f32 products sum in another order (the port in rank order, XLA in its
    own), so the f32 sums differ by a few ulps of the delta (of order 0.05
    here).  A merged value sits at most one bf16 step from the JAX one, plus
    2^-21 where W and the delta cancel to a small sum (measured: one value of
    131,072, 1.013e-6 against 9.98e-7, two bf16 steps).
  * quantized kernels: dequantize to f32, add the delta, requantize.  The
    port's quantizers are bit-exact with the JAX package's numpy ones; the JAX
    merge requantizes with the jitted ``quantize_jax``, which puts a few
    values one step from the numpy quantizer (ROADMAP §3: 5 of 524,288 LM
    head values).  The integer fields may differ by one step at no more than
    1e-4 of their values, the f16 scale fields by one f16 ulp at no more than
    1e-3 of theirs; everything else is equal (measured here: none differ).
  * the runtime: ``deactivate`` rebuilds from the pristine tree, so the
    engine's output is the base's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import loader as jloader
from acestep_tpu.quant import QuantTensor as JQuantTensor
from acestep_tpu.models import dit as jdit
from acestep_tpu.quant import quantize_np, quantize_tree_jax
from acestep_tpu.training import lora as jlora
from acestep_tpu_torch import lora_runtime, weights
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.config import VAEConfig
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.training import lora as tlora
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import (KERNEL_GAIN, _quant_policy, _scale_kernels, port_cfg,
                                     to_np)

ALPHA = 8.0
RANK = 4
INT_STEP_SHARE = 1e-4
SCALE_ULP_SHARE = 1e-3
BF16_CANCEL_ATOL = 2.0 ** -21


def _tree(rng, fmt):
    """A two-layer tree of targeted kernels (q_proj [256, 128], down_proj
    [512, 256]) and untargeted leaves, as numpy; quantized with the JAX
    package's numpy quantizer unless ``fmt`` is bf16."""

    def kernel(k, n):
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        return jnp.asarray(w, jnp.bfloat16) if fmt == "bf16" else quantize_np(w, fmt)

    return {"layers": [{"self_attn": {"q_proj": {"kernel": kernel(256, 128)},
                                      "q_norm": jnp.ones((16,), jnp.bfloat16)},
                        "mlp": {"down_proj": {"kernel": kernel(512, 256)}}} for _ in range(2)],
            "proj_out": {"kernel": kernel(256, 64)}}


def _adapter(rng, tree):
    """Rank-4 adapters on both layers' q_proj and down_proj (b non-zero),
    none on proj_out; f32 numpy."""
    def leaf(k, n):
        return {"a": (rng.standard_normal((k, RANK)) / RANK).astype(np.float32),
                "b": (rng.standard_normal((RANK, n)) * 0.05).astype(np.float32)}

    return {"layers": [{"self_attn": {"q_proj": {"kernel": leaf(256, 128)}},
                        "mlp": {"down_proj": {"kernel": leaf(512, 256)}}} for _ in range(2)]}


def _to_port_adapter(tree):
    if isinstance(tree, dict):
        return {k: _to_port_adapter(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port_adapter(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def assert_merge_matches(got, ref, untouched=()):
    """``got`` (port tree) against ``ref`` (JAX tree) at the module's bounds."""
    n_int = n_int_off = n_scale = n_scale_off = 0
    for (path, g), (rpath, r) in zip(_leaves(got), _leaves(ref)):
        assert path == rpath
        if isinstance(g, QuantTensor):
            assert isinstance(r, JQuantTensor) and g.fmt == r.fmt
            for f, a in g.fields().items():
                ga, ra = _np(a), np.asarray(getattr(r, f))
                assert ga.shape == ra.shape and ga.dtype == ra.dtype, (path, f)
                if ga.dtype == np.float16:
                    off = ga != ra
                    steps = np.abs(ga.view(np.int16).astype(np.int32)
                                   - ra.view(np.int16).astype(np.int32))
                    assert steps.max() <= 1, (path, f)
                    n_scale += ga.size
                    n_scale_off += int(off.sum())
                else:
                    if ga.dtype == np.uint8 and f in ("data", "data_hi"):
                        ga, ra = _unpack(ga, f), _unpack(ra, f)
                    d = np.abs(ga.astype(np.int32) - ra.astype(np.int32))
                    assert d.max() <= 1, (path, f)
                    n_int += d.size
                    n_int_off += int((d > 0).sum())
        else:
            ga, ra = _np(g), _np(r)
            if any(path.startswith(u) for u in untouched) or ga.ndim != 2:
                np.testing.assert_array_equal(ga, ra)
            else:            # bf16: one step, plus the f32 sums' few ulps
                step = np.abs(ra) * 2.0 ** -7 + BF16_CANCEL_ATOL
                assert (np.abs(ga - ra) <= step).all(), path
    assert n_int_off <= INT_STEP_SHARE * max(n_int, 1), (n_int_off, n_int)
    assert n_scale_off <= SCALE_ULP_SHARE * max(n_scale, 1), (n_scale_off, n_scale)


def _unpack(packed, field):
    """Nibbles (data) or crumbs (data_hi) as separate values."""
    if field == "data":
        return np.stack([packed & 0xF, packed >> 4])
    return np.stack([(packed >> s) & 0x3 for s in (0, 2, 4, 6)])


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_k"])
def test_apply_lora_matches_jax(fmt):
    rng = np.random.default_rng({"bf16": 0, "q8_0": 1, "q4_k": 2}[fmt])
    base = _tree(rng, fmt)
    lora = _adapter(rng, base)
    ref = jlora.apply_lora(base, jax.tree_util.tree_map(jnp.asarray, lora), alpha=ALPHA)
    port_base = weights.from_jax_numpy(to_np(base))
    got = tlora.apply_lora(port_base, _to_port_adapter(lora), alpha=ALPHA)
    assert_merge_matches(got, to_np(ref), untouched=("/proj_out",))
    # untargeted leaves are the base's own objects
    assert got["proj_out"]["kernel"] is port_base["proj_out"]["kernel"]
    # scale_lora scales b only, as the JAX one does
    scaled = tlora.scale_lora(_to_port_adapter(lora), 0.5)
    ref_scaled = jlora.scale_lora(lora, 0.5)
    for (p, a), (_, b) in zip(_leaves(scaled), _leaves(ref_scaled)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tiny_engine(base):
    """A CPU engine around ``base`` (an unstacked q8_0 DiT tree) with a small
    random VAE and text encoder."""
    vae_cfg = VAEConfig(audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
                        decoder_input_channels=8, downsampling_ratios=(2, 4, 4),
                        channel_multiples=(1, 2, 4))
    init = RandomInit(torch.device("cpu"), 5, None)
    return tpipeline.AceStepEngine(base, port_cfg(TINY_DIT), init.vae(vae_cfg), vae_cfg,
                                   init.qwen(port_cfg(TINY_TEXT)), port_cfg(TINY_TEXT),
                                   device="cpu")


def _dit_q8():
    """The JAX package's tiny DiT tree, q8_0 (as jax_params makes it)."""
    rng = np.random.default_rng(4)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    return quantize_tree_jax(_scale_kernels(jdit.init_params(jax.random.key(4), TINY_DIT,
                                                             sampler=sampler), KERNEL_GAIN),
                             "q8_0", policy=_quant_policy)


def test_runtime_lifecycle_and_jax_saved_adapter(tmp_path):
    dp = _dit_q8()
    # an adapter on the decoder layers' attention and MLP kernels, b non-zero,
    # saved with the JAX package's loader
    rng = np.random.default_rng(2)
    lora = {"layers": [{group: {name: {"kernel": {
        "a": (rng.standard_normal((k.shape[0], RANK)) / RANK).astype(np.float32),
        "b": (rng.standard_normal((RANK, k.shape[1])) * 0.05).astype(np.float32)}}
        for name, k in ((n, layer[group][n]["kernel"]) for n in names)}
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj")))}
        for layer in dp["layers"]]}
    jloader.save_params(str(tmp_path / "adapter"), lora)

    base = weights.from_jax_numpy(to_np(dp))
    engine = _tiny_engine(base)
    rt = lora_runtime.LoRARuntime(engine, base)
    rng = np.random.default_rng(0)
    req = tpipeline.GenerationRequest(duration_s=10.0, seeds=[1],
                                      style_token_ids=rng.integers(0, 256, (1, 6)))
    noise = torch.from_numpy(rng.standard_normal((1, 256, 8)).astype(np.float32))
    before = engine.dit_params
    base_out = engine.generate(req, noise=noise)

    rt.register_from_dir("style_a", str(tmp_path / "adapter"), alpha=ALPHA)
    assert rt.list_adapters() == {"style_a": {"alpha": ALPHA, "scale": 1.0, "active": False}}
    rt.activate("style_a")
    assert rt.list_adapters()["style_a"]["active"] is True
    # the JAX-saved adapter, read by the port's loader, is the JAX tree's
    # arrays: the merge equals the port's merge of those arrays bit for bit
    # (the merge itself is held to the JAX one in test_apply_lora_matches_jax)
    want = tlora.apply_lora(base, weights.from_jax_numpy(lora), alpha=ALPHA)
    for (p, a), (_, b) in zip(_leaves(rt.merged_params()), _leaves(want)):
        fa = a.fields() if isinstance(a, QuantTensor) else {"": a}
        fb = b.fields() if isinstance(b, QuantTensor) else {"": b}
        assert all(torch.equal(fa[f], fb[f]) for f in fb), p
    on = engine.generate(req, noise=noise)
    assert np.abs(on.latents - base_out.latents).max() > 1e-3

    rt.set_scale("style_a", 0.5)
    half = engine.generate(req, noise=noise)
    assert np.abs(half.latents - on.latents).max() > 1e-4
    assert np.abs(half.latents - base_out.latents).max() > 1e-4

    rt.deactivate("style_a")
    restored = engine.generate(req, noise=noise)
    np.testing.assert_array_equal(restored.latents, base_out.latents)
    np.testing.assert_array_equal(restored.audio_i16, base_out.audio_i16)
    # the rebuilt tree is the engine's init layout, leaf for leaf
    for (p, a), (_, b) in zip(_leaves(engine.dit_params), _leaves(before)):
        fa = a.fields() if isinstance(a, QuantTensor) else {"": a}
        fb = b.fields() if isinstance(b, QuantTensor) else {"": b}
        assert fa.keys() == fb.keys(), p
        for f in fa:
            assert fa[f].dtype == fb[f].dtype and torch.equal(fa[f], fb[f]), (p, f)

    with pytest.raises(KeyError, match="unknown adapter"):
        rt.activate("missing")
    rt.activate("style_a", scale=0.5)
    rt.unregister("style_a")
    assert rt.list_adapters() == {}
    np.testing.assert_array_equal(engine.generate(req, noise=noise).latents, base_out.latents)
