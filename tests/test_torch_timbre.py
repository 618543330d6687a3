"""Port parity of the timbre encoder and the condition packing with reference
latents (acestep_tpu_torch.models.dit.timbre_encoder,
pipeline.encode_condition / AceStepEngine.build_condition) against the JAX
package, on the CPU, and the random-init timbre weights' layout.

Parameters are test_torch_models.py's q8_0 tiny DiT (kernels scaled x4) with
a random special token; the reference latents are numpy draws.  Tolerance:
the lyric-encoder bound of test_torch_models.py (cosine >= 0.9995, four bf16
steps at the peak); the packed mask and the token order exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import pipeline as jpipeline
from acestep_tpu.config import DiTConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.quant import QuantTensor as JQuantTensor
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from acestep_tpu_torch.models import dit as tdit
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.quant import QuantTensor
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, assert_bf16_close, jax_params, port_cfg, to_np

DIM = TINY_DIT.timbre_hidden_dim


@pytest.fixture(scope="module")
def params():
    dp, tp, vp = jax_params(seed=5)
    rng = np.random.default_rng(5)
    dp = dict(dp, timbre_special_token=jnp.asarray(
        rng.standard_normal(TINY_DIT.hidden_size).astype(np.float32), jnp.bfloat16))
    return dp, tp, vp


@pytest.fixture(scope="module")
def engines(params):
    dp, tp, vp = params
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    return jeng, teng


def test_timbre_encoder_matches_jax(params):
    """Two clips of 751 tokens (the special token and 750 frames), the second
    a 5-frame clip zero-padded with its frame mask (the tiny model's one
    timbre layer slides with window 8, so its padding is in the token's reach)."""
    dp, _, _ = params
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 750, DIM)).astype(np.float32)
    x[1, 5:] = 0.0
    fm = np.ones((2, 750), np.int32)
    fm[1, 5:] = 0
    enc = jax.jit(lambda p, x, m: jdit.timbre_encoder(p, TINY_DIT, x, m))
    ref = np.asarray(enc(jdit.stack_params(dp), jnp.asarray(x), jnp.asarray(fm)))
    tp = weights.from_jax_numpy(to_np(dp))
    got = tdit.timbre_encoder(tp, port_cfg(TINY_DIT), torch.from_numpy(x), torch.from_numpy(fm))
    assert got.shape == ref.shape == (2, 1, TINY_DIT.hidden_size) and got.dtype == torch.float32
    assert_bf16_close(got, ref)
    # the frame mask matters: the same clip unmasked is another token
    free = tdit.timbre_encoder(tp, port_cfg(TINY_DIT), torch.from_numpy(x))
    assert (free[1] - got[1]).abs().max() > 1e-3


@pytest.mark.parametrize("refer_mask", [None, [[1, 0]]])
def test_build_condition_with_refer(engines, refer_mask):
    """[lyric | timbre | style] packed valid-first: mask exact, the values at
    the bound (a 40-frame and a 900-frame clip: padded and cut to 750)."""
    jeng, teng = engines
    rng = np.random.default_rng(2)
    refer = np.zeros((1, 2, 900, DIM), np.float32)
    refer[0, 0, :40] = rng.standard_normal((40, DIM))
    refer[0, 1] = rng.standard_normal((900, DIM))
    lyric_mask = np.ones((1, 30), np.int32)
    lyric_mask[0, 22:] = 0
    kw = dict(style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 12)),
              lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 30)),
              lyric_mask=lyric_mask, refer_latents=refer,
              refer_mask=None if refer_mask is None else np.asarray(refer_mask, np.int32))
    ref_h, ref_m = jeng.build_condition(jpipeline.GenerationRequest(**kw), 1)
    got_h, got_m = teng.build_condition(tpipeline.GenerationRequest(**kw), 1)
    ref_m = np.asarray(ref_m)
    np.testing.assert_array_equal(got_m.numpy(), ref_m)
    n_valid = 22 + 12 + (2 if refer_mask is None else 1)
    assert int(ref_m.sum()) == n_valid and ref_m[0, :n_valid].all()
    assert got_h.dtype == torch.float32 and got_h.shape == np.asarray(ref_h).shape
    valid = ref_m[0].astype(bool)
    assert_bf16_close(got_h[0].numpy()[valid], np.asarray(ref_h, np.float32)[0][valid])
    # the timbre tokens sit between the lyric and the style tokens
    toks = tdit.timbre_encoder(teng.dit_params, teng.dit_cfg, torch.from_numpy(
        np.pad(refer[0, :1, :40], ((0, 0), (0, 710), (0, 0)))),
        torch.from_numpy((np.arange(750) < 40).astype(np.int32)[None]))
    assert_bf16_close(got_h[0, 22], toks[0, 0])


@pytest.mark.parametrize("refer_mask", [None, [[0, 1, 1]]])
def test_encode_timbre_matches_jax(engines, refer_mask):
    """The engine's encode_timbre (three 40-frame clips, no frame mask): the
    tokens at the bound, the clip mask exact."""
    jeng, teng = engines
    refer = np.random.default_rng(3).standard_normal((1, 3, 40, DIM)).astype(np.float32)
    m = None if refer_mask is None else np.asarray(refer_mask, np.int32)
    ref_t, ref_m = jeng.encode_timbre(refer, m)
    got_t, got_m = teng.encode_timbre(refer, m)
    assert got_t.shape == np.asarray(ref_t).shape == (1, 3, TINY_DIT.hidden_size)
    assert_bf16_close(got_t, np.asarray(ref_t))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _layout(leaf):
    if isinstance(leaf, (QuantTensor, JQuantTensor)):
        return leaf.fmt, tuple(int(s) for s in leaf.shape)
    return "bf16" if "bfloat16" in str(leaf.dtype) else str(leaf.dtype), tuple(leaf.shape)


def test_random_init_timbre_layout_matches_quantize_tree_jax():
    """At 1024 wide and q4_k: the timbre weights' names, shapes and formats
    equal the JAX package's init_params + quantize_tree_jax (timbre_embed,
    64 x 1024 = 65536 elements, falls back to q8_0 at K = 64)."""
    cfg = DiTConfig(hidden_size=1024, intermediate_size=1024, num_hidden_layers=1,
                    num_attention_heads=8, num_key_value_heads=4, head_dim=128,
                    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=2,
                    text_hidden_dim=256)
    shapes = jax.eval_shape(lambda k: jdit.init_params(k, cfg), jax.random.key(0))
    rng = np.random.default_rng(0)
    timbre = {k: jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.02, s.dtype),
        v) for k, v in shapes.items() if k.startswith("timbre")}
    ref = dict(_leaves(quantize_tree_jax(timbre, "q4_k")))
    got_tree = RandomInit(torch.device("cpu"), 0, "q4_k").dit(port_cfg(cfg))
    got = dict(_leaves({k: v for k, v in got_tree.items() if k.startswith("timbre")}))
    assert sorted(got) == sorted(ref)
    assert {p: _layout(v) for p, v in got.items()} == {p: _layout(v) for p, v in ref.items()}
    assert _layout(got["/timbre_embed/kernel"]) == ("q8_0", (64, 1024))
    assert _layout(got["/timbre_layers/1/mlp/down_proj/kernel"]) == ("q4_k", (1024, 1024))


def test_port_config_keeps_the_timbre_fields():
    pc = port_cfg(TINY_DIT)
    for f in ("timbre_hidden_dim", "num_timbre_encoder_hidden_layers", "timbre_fix_frame"):
        assert getattr(pc, f) == getattr(TINY_DIT, f)
    assert dataclasses.asdict(pc) == dataclasses.asdict(TINY_DIT)
