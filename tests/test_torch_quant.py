"""Port parity: q8_0 format (acestep_tpu_torch.quant) against the JAX package's
quant/formats.py, on the CPU.  Tolerance: bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.quant import formats as jfmt
from acestep_tpu_torch import weights
from acestep_tpu_torch.quant import QuantTensor, concat_n, dequantize, quantize_q8_0


def _w(k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[:, 0] = 0.0                                   # an all-zero block column
    w[3, 1] = 1.5                                   # one outlier per block
    return w


def _port(qt_j) -> QuantTensor:
    return weights.from_jax_numpy(qt_j)


@pytest.mark.parametrize("k,n", [(32, 8), (256, 96), (1024, 40)])
def test_dequant_bit_exact(k, n):
    qt_j = jfmt.quantize_q8_0_np(_w(k, n, k + n))
    ref = jfmt.dequantize_np(qt_j)
    got = dequantize(_port(qt_j), torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    # bf16 dequant: one rounding of the f32 product, same as the JAX path
    ref16 = np.asarray(jfmt.dequantize(qt_j, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(dequantize(_port(qt_j)).float().numpy(), ref16)


@pytest.mark.parametrize("k,n", [(64, 16), (512, 48)])
def test_quantize_matches_numpy_reference(k, n):
    w = _w(k, n, 7 * k + n)
    qt_j = jfmt.quantize_q8_0_np(w)
    qt = quantize_q8_0(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qt_j.data))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(qt_j.scales))
    assert qt.scales.dtype == torch.float16 and qt.shape == (k, n)


def test_round_half_away_from_zero():
    # exact halves after scaling: 127 * (x / amax) lands on .5 for these values
    w = np.zeros((32, 1), np.float32)
    w[0, 0] = 127.0
    w[1, 0] = 0.5
    w[2, 0] = -0.5
    w[3, 0] = 2.5
    qt = quantize_q8_0(torch.from_numpy(w))
    np.testing.assert_array_equal(qt.data.numpy()[:4, 0], [127, 1, -1, 3])


def test_stacked_layer_view_and_concat():
    a = quantize_q8_0(torch.from_numpy(_w(64, 8, 1)))
    b = quantize_q8_0(torch.from_numpy(_w(64, 8, 2)))
    st = QuantTensor("q8_0", (64, 8), torch.stack([a.data, b.data]),
                     torch.stack([a.scales, b.scales]))
    assert st.stacked and st.num_layers == 2
    np.testing.assert_array_equal(dequantize(st.layer(1)).float().numpy(),
                                  dequantize(b).float().numpy())
    cat = concat_n([a, b])
    assert cat.shape == (64, 16)
    np.testing.assert_array_equal(
        dequantize(cat).float().numpy(),
        np.concatenate([dequantize(a).float().numpy(), dequantize(b).float().numpy()], 1))


def test_rejects_other_formats_and_shapes():
    with pytest.raises(ValueError):
        quantize_q8_0(torch.zeros(33, 4))
    with pytest.raises(ValueError):            # a format the port does not have
        QuantTensor("q5_1", (32, 4), torch.zeros(32, 4, dtype=torch.int8),
                    torch.zeros(1, 4))
    with pytest.raises(ValueError):            # 4-bit K must be a multiple of 256
        QuantTensor("q4_0", (32, 4), torch.zeros(16, 4, dtype=torch.uint8),
                    torch.zeros(1, 4))
