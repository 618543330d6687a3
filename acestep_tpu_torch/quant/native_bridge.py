"""Host quantization through the native C++ quantizers (``acestep_tpu_torch.native``),
bit-exact with :func:`formats.quantize` on the CPU.

Shapes the C++ does not take (a K that is not a multiple of the format's
block) go to :func:`formats.quantize` on the CPU, which raises for them as
the numpy quantizers do.  A native module that cannot be built is an error.
"""

from __future__ import annotations

import numpy as np
import torch

from acestep_tpu_torch.native import get_native

from .formats import BLOCK, FOLD, SUPER, QuantTensor, quantize

# K must be a multiple of this for the C++ loop of each format
_NATIVE_ALIGN = {"q8_0": BLOCK, "q4_0": FOLD, "q4_k": SUPER, "q6_k": SUPER}


def quantize_native(w: np.ndarray, fmt: str) -> QuantTensor:
    """Quantize the kernel ``w`` [K, N] to ``fmt``; a QuantTensor of CPU tensors."""
    w = np.ascontiguousarray(w, dtype=np.float32)
    if w.ndim != 2 or fmt not in _NATIVE_ALIGN or w.shape[0] % _NATIVE_ALIGN[fmt]:
        return quantize(torch.from_numpy(w), fmt)
    nat = get_native()
    k, n = w.shape
    t = torch.from_numpy
    if fmt == "q8_0":
        data = np.empty((k, n), np.int8)
        scales = np.empty((k // BLOCK, n), np.uint16)
        nat.quantize_q8_0(w, k, n, data, scales)
        return QuantTensor("q8_0", (k, n), t(data), scales=t(scales.view(np.float16)))
    if fmt == "q4_0":
        data = np.empty((k // 2, n), np.uint8)
        scales = np.empty((k // BLOCK, n), np.uint16)
        nat.quantize_q4_0(w, k, n, data, scales)
        return QuantTensor("q4_0", (k, n), t(data), scales=t(scales.view(np.float16)))
    if fmt == "q4_k":
        data = np.empty((k // 2, n), np.uint8)
        ls = np.empty((k // BLOCK, n), np.uint8)
        lm = np.empty((k // BLOCK, n), np.uint8)
        ds = np.empty((k // SUPER, n), np.uint16)
        ms = np.empty((k // SUPER, n), np.uint16)
        nat.quantize_q4_k(w, k, n, data, ls, lm, ds, ms)
        return QuantTensor("q4_k", (k, n), t(data), sub_scales=t(ls), sub_mins=t(lm),
                           super_scales=t(ds.view(np.float16)),
                           super_mins=t(ms.view(np.float16)))
    data = np.empty((k // 2, n), np.uint8)
    hi = np.empty((k // 4, n), np.uint8)
    ls = np.empty((k // 16, n), np.int8)
    ds = np.empty((k // SUPER, n), np.uint16)
    nat.quantize_q6_k(w, k, n, data, hi, ls, ds)
    return QuantTensor("q6_k", (k, n), t(data), data_hi=t(hi), sub_scales=t(ls),
                       super_scales=t(ds.view(np.float16)))


def f32_to_bf16_fast(x: np.ndarray) -> np.ndarray:
    """Raw bf16 bits (uint16, round to nearest even) of ``x`` through the
    native loop: for finite values the bits of ``torch``'s bf16 cast."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, np.uint16)
    get_native().bf16_from_f32(x.reshape(-1), out.reshape(-1), x.size)
    return out
