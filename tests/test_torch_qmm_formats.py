"""Port parity: the plain q4_0 / q4_k / q6_k dequant-matmul of
acestep_tpu_torch.ops.cuda.qmm (what a CPU tensor runs, and the reference the
CUDA kernels are held to on the card) against the JAX package's Pallas kernels
in interpret mode, 2-D (``qmm_pallas``) and layer-stacked
(``qmm_pallas_stacked``), on the same numpy inputs.

Inputs are made as the Pallas kernel test makes them (test_qmm_pallas.py
``_pair``: seed 0 for the 2-D case, seeds 0 and 1 for the two layers of the
stacked one), and so is the tolerance (test_qmm_pallas.py:33-36): the largest
difference below 2% of the mean |output| and at least 98% of the bf16 outputs
equal, since the two sum in f32 in different orders.  Each output is also held
within one bf16 step (2^-7) of the reference.  The 2% bound is met by these
inputs with room, but not by every seed: a single bf16 flip at the largest
output is ~2.5% of the mean, and the JAX package's own XLA path misses the
bound against its Pallas kernel that way too (q4_k at (100, 1024, 256) with
seed 1124).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.ops.pallas.qmm import qmm_pallas, qmm_pallas_stacked
from acestep_tpu.ops.qlinear import precast_quant_scales as jprecast
from acestep_tpu.quant import quantize_np
from acestep_tpu_torch import weights
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.quant import stack_layers

REL_MAX = 0.02
EQUAL_MIN = 0.98
SHAPES = [(64, 512, 256), (100, 1024, 256), (7, 512, 128)]


def _pair(fmt, k, n, m, seed=0):
    """test_qmm_pallas.py's ``_pair``: x [M, K] (bf16 values, as f32) and a
    quantized weight from one numpy seed."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16), np.float32)
    return x, quantize_np(w, fmt)


def _assert_close(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref)
    assert err.max() / (np.abs(ref).mean() + 1e-9) < REL_MAX
    assert (got == ref).mean() > EQUAL_MIN
    assert (err <= 2.0 ** -7 * np.abs(ref) + 1e-4 * np.abs(ref).mean()).all()


@pytest.mark.parametrize("fmt", ["q4_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_pallas(fmt, m, k, n):
    x, qt_j = _pair(fmt, k, n, m)
    ref = qmm_pallas(jnp.asarray(x, jnp.bfloat16), qt_j, interpret=True)
    qt = precast_quant_scales(weights.from_jax_numpy(qt_j))
    got = tqmm.qmm(torch.from_numpy(x).bfloat16(), qt)
    assert got.dtype == torch.bfloat16
    _assert_close(got, ref)


@pytest.mark.parametrize("fmt", ["q4_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_stacked_matches_pallas_stacked(fmt, m, k, n):
    x, qt0 = _pair(fmt, k, n, m, seed=0)
    layers = [qt0, _pair(fmt, k, n, m, seed=1)[1]]
    stacked_j = jprecast(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *layers))
    st = stack_layers([precast_quant_scales(weights.from_jax_numpy(q)) for q in layers])
    xb = jnp.asarray(x, jnp.bfloat16)
    for li in range(2):
        ref = qmm_pallas_stacked(xb, stacked_j, jnp.int32(li), interpret=True)
        _assert_close(tqmm.qmm_stacked(torch.from_numpy(x).bfloat16(), st, li), ref)
