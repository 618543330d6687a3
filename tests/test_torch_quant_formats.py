"""Port parity: the q4_0, q4_k and q6_k formats of acestep_tpu_torch.quant
against the JAX package's quant/formats.py (numpy reference quantizers,
``dequantize_np``, the fold packings, ``supported_format_for``), on the CPU.
Tolerance: bit-exact, field by field."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.quant import formats as jfmt
from acestep_tpu_torch import weights
from acestep_tpu_torch.quant import (
    FIELDS,
    QuantTensor,
    concat_n,
    dequantize,
    quantize,
    stack_layers,
    supported_format_for,
)
from acestep_tpu_torch.quant import formats as tfmt

FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
FOUR_BIT = ("q4_0", "q4_k", "q6_k")
_NP_QUANTIZERS = {"q4_0": jfmt.quantize_q4_0_np, "q4_k": jfmt.quantize_q4_k_np,
                  "q6_k": jfmt.quantize_q6_k_np, "q8_0": jfmt.quantize_q8_0_np}


def _w(k, n, seed):
    """Random weights with the edge cases of a block: an all-zero column, an
    outlier, an all-negative run, an all-positive column and a +/- tie of the
    absmax (first index wins)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[:, 0] = 0.0
    w[3, 1] = 1.5
    w[5:40, 2] = -0.3
    w[:, 3] = np.abs(w[:, 3])
    w[7, 4], w[9, 4] = 0.2, -0.2
    return w


def _assert_fields_equal(got: QuantTensor, ref):
    assert got.fmt == ref.fmt and tuple(got.shape) == tuple(ref.shape)
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype and tuple(b.shape) == a.shape, f
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f)


@pytest.mark.parametrize("fmt", FOUR_BIT)
@pytest.mark.parametrize("k,n", [(256, 40), (512, 96), (1024, 24)])
def test_quantize_matches_numpy_reference(fmt, k, n):
    w = _w(k, n, 3 * k + n)
    _assert_fields_equal(quantize(torch.from_numpy(w), fmt), _NP_QUANTIZERS[fmt](w))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k,n", [(256, 40), (768, 64)])
def test_dequantize_bit_exact(fmt, k, n):
    qt_j = _NP_QUANTIZERS[fmt](_w(k, n, k + 5 * n))
    qt = weights.from_jax_numpy(qt_j)
    np.testing.assert_array_equal(dequantize(qt, torch.float32).numpy(),
                                  jfmt.dequantize_np(qt_j))
    ref16 = np.asarray(jfmt.dequantize(qt_j, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(dequantize(qt).float().numpy(), ref16)


def test_q4_0_rounds_with_floor_plus_8_5():
    # d = signed absmax / -8 = -1: x/d + 8.5 lands exactly on .5 and .0 values,
    # where floor differs from round-half-away-from-zero
    w = np.zeros((256, 1), np.float32)
    w[0, 0] = 8.0
    w[1:6, 0] = [0.5, -0.5, 1.5, -2.5, 3.0]
    qt = quantize(torch.from_numpy(w), "q4_0")
    ref = jfmt.quantize_q4_0_np(w)
    _assert_fields_equal(qt, ref)
    q = tfmt.unpack_nibbles(qt.data).numpy()[:6, 0]
    np.testing.assert_array_equal(q, np.floor(-w[:6, 0] + 8.5).clip(0, 15))


@pytest.mark.parametrize("k", [256, 768])
def test_pack_unpack_round_trips(k):
    rng = np.random.default_rng(k)
    nib = rng.integers(0, 16, (k, 24)).astype(np.uint8)
    crumb = rng.integers(0, 4, (k, 24)).astype(np.uint8)
    packed = tfmt.pack_nibbles(torch.from_numpy(nib))
    np.testing.assert_array_equal(packed.numpy(), jfmt._pack_nibbles(nib))
    np.testing.assert_array_equal(tfmt.unpack_nibbles(packed).numpy(), nib)
    packed = tfmt.pack_crumbs(torch.from_numpy(crumb))
    np.testing.assert_array_equal(packed.numpy(), jfmt._pack_crumbs(crumb))
    np.testing.assert_array_equal(tfmt.unpack_crumbs(packed).numpy(), crumb)
    # a leading layer axis passes through
    stacked = torch.from_numpy(np.stack([nib, nib[::-1].copy()]))
    np.testing.assert_array_equal(tfmt.unpack_nibbles(tfmt.pack_nibbles(stacked)).numpy(),
                                  stacked.numpy())


def test_supported_format_for_matches_jax():
    for k in (32, 64, 256, 384, 1024, 48):
        for fmt in FORMATS + ("bf16", "f32"):
            assert supported_format_for(k, fmt) == jfmt.supported_format_for(k, fmt), (k, fmt)


@pytest.mark.parametrize("fmt", FORMATS)
def test_concat_stack_and_layer_on_every_field(fmt):
    a = quantize(torch.from_numpy(_w(512, 32, 1)), fmt)
    b = quantize(torch.from_numpy(_w(512, 48, 2)), fmt)
    cat = concat_n([a, b])
    assert cat.shape == (512, 80) and set(cat.fields()) == set(a.fields())
    np.testing.assert_array_equal(
        dequantize(cat, torch.float32).numpy(),
        np.concatenate([dequantize(a, torch.float32).numpy(),
                        dequantize(b, torch.float32).numpy()], axis=1))
    c = quantize(torch.from_numpy(_w(512, 32, 3)), fmt)
    st = stack_layers([a, c])
    assert st.stacked and st.num_layers == 2 and st.nbytes == a.nbytes + c.nbytes
    for li, one in enumerate((a, c)):
        view = st.layer(li)
        for f, t in one.fields().items():
            assert torch.equal(getattr(view, f), t), f
    np.testing.assert_array_equal(dequantize(st, torch.float32)[1].numpy(),
                                  dequantize(c, torch.float32).numpy())
    moved = st.to("cpu")
    assert set(moved.fields()) == set(st.fields())
