"""Quantized linear: ``y = x @ W (+ b)`` with f32 accumulation; the output dtype
follows x.

W is a plain tensor ``[K, N]``, a :class:`QuantTensor` (q8_0, q4_0, q4_k or
q6_k), or a :class:`StackedWeight` (layer ``idx`` of a weight stacked
``[L, K, N]``, read in place).  Quantized weights go through the format's
dequant-matmul (``ops.cuda.qmm``: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors).  ``int8_act`` sends q8_0 weights with at most 16
rows to the int8-activation kernel (``ops.cuda.qmm.qmm_nd``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from acestep_tpu_torch.ops.cuda import qmm as _qmm
from acestep_tpu_torch.quant import QuantTensor, concat_n


_F32_FIELDS = ("scales", "super_scales", "super_mins")


class StackedWeight:
    """Layer ``idx`` of a stacked weight ``[L, K, N]`` (tensor or QuantTensor)."""

    __slots__ = ("w", "idx")

    def __init__(self, w, idx: int):
        self.w = w
        self.idx = idx


Weight = Union[torch.Tensor, QuantTensor, StackedWeight]


def linear(x: torch.Tensor, w: Weight, bias: Optional[torch.Tensor] = None,
           int8_act: bool = False) -> torch.Tensor:
    """``x [..., K] @ w [K, N] -> [..., N]`` in x's dtype."""
    out_dtype = x.dtype
    if isinstance(w, StackedWeight):
        if isinstance(w.w, QuantTensor):
            return _qmm.qmm_stacked_nd(x, w.w, w.idx, bias, out_dtype, int8_act)
        w = w.w[w.idx]
    if isinstance(w, QuantTensor):
        return _qmm.qmm_nd(x, w, bias, out_dtype, int8_act)
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def concat_weights_n(ws):
    """Concatenate kernel weights along N (exact column-for-column), to fuse
    q||k||v and gate||up into one weight stream."""
    if isinstance(ws[0], QuantTensor):
        return concat_n(ws)
    return torch.cat(ws, dim=-1)


def precast_quant_scales(tree):
    """Cast every QuantTensor's ``scales``, ``super_scales`` and ``super_mins``
    to f32 once (exact upcast from f16): the kernels read f32 scales.  Integer
    sub-scales keep their type."""
    if isinstance(tree, dict):
        return {k: precast_quant_scales(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [precast_quant_scales(v) for v in tree]
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.fmt, tree.shape, **{
            f: a.float() if f in _F32_FIELDS else a for f, a in tree.fields().items()})
    return tree
