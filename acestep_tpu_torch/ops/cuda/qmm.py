"""Dequant-matmuls for every quant format: CUDA kernel wrappers, their plain
PyTorch version and the 2-D / n-D / layer-stacked entry points.

Kernels (hand-written for sm_90a, WMMA bf16 tensor cores, f32 accumulation):

  q8_0  csrc/qmm_q8_0.cu  replaces acestep_tpu/ops/pallas/qmm.py:147 _q8_kernel
  q4_0  csrc/qmm_q4.cu    replaces qmm.py:164 _q4_0_kernel
  q4_k  csrc/qmm_q4.cu    replaces qmm.py:187 _q4_k_kernel
  q6_k  csrc/qmm_q4.cu    replaces qmm.py:208 _q6_k_kernel

each reached through ``qmm_pallas`` / ``qmm_pallas_nd`` and, for the DiT's
layer-stacked weights, ``qmm_pallas_stacked`` (scalar-prefetched layer index):
here the stacked form passes the base pointers of layer ``li`` to the same
kernel, so no per-layer weight copy is made either.  Every kernel streams the
quantized fields as stored and dequantizes them in shared memory, so device
memory never holds a bf16 copy of W.

With ``int8_act`` (the JAX package's ``ACESTEP_TPU_INT8_ACT=1``), the n-D and
stacked entry points send a q8_0 weight with a flattened M of at most 16 to

  int8  csrc/qmm_int8.cu  replaces qmm.py:608 _int8_core_kernel (ops/cuda/qmm_int8.py)

as ``qmm_pallas_nd`` does (qmm.py:348-367), unless N % 128 != 0, where the JAX
``qmm_int8_act`` falls back to a bf16 dequant matmul: that is the q8_0 kernel
here.  The int8 route returns bf16 and a bias is added after it in f32, with a
second rounding, as the JAX ``linear`` does after its kernel.

Numerics (the JAX package's, qmm.py:18-19): dequant in f32, one rounding to
bf16, f32 accumulation; the bias is added in f32 before the one output rounding.

Dispatch on ``qt.fmt``: a CPU tensor takes :func:`qmm_plain`; a CUDA tensor
launches the format's kernel or raises.  Each kernel has its own entry in
:data:`KERNELS`: ``launches`` counts its launches, ``shapes`` counts them by
``(M, K, N)``, so a run can show which kernels and shapes its path used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.cuda import qmm_int8 as _int8
from acestep_tpu_torch.quant import BLOCK, FOLD, SUB16, SUPER, QuantTensor, dequantize


@dataclasses.dataclass(kw_only=True)
class Kernel(_build.Counted):
    """One format's kernel: its counts (``Counted``) and its C entry point."""

    entry: str
    # (field, dtype, K rows per stored row) in the entry point's argument order
    fields: tuple


_U8, _I8, _F32 = torch.uint8, torch.int8, torch.float32
_Q4_SRC = "acestep_tpu_torch/csrc/qmm_q4.cu"
KERNELS = {
    "q8_0": Kernel("q8_0_qmm", "acestep_tpu_torch/csrc/qmm_q8_0.cu",
                   "acestep_tpu/ops/pallas/qmm.py:147", entry="acestep_qmm_q8_0",
                   fields=(("data", _I8, 1), ("scales", _F32, BLOCK))),
    "q4_0": Kernel("q4_0_qmm", _Q4_SRC, "acestep_tpu/ops/pallas/qmm.py:164",
                   entry="acestep_qmm_q4_0",
                   fields=(("data", _U8, 2), ("scales", _F32, BLOCK))),
    "q4_k": Kernel("q4_k_qmm", _Q4_SRC, "acestep_tpu/ops/pallas/qmm.py:187",
                   entry="acestep_qmm_q4_k",
                   fields=(("data", _U8, 2), ("sub_scales", _U8, BLOCK),
                           ("sub_mins", _U8, BLOCK), ("super_scales", _F32, SUPER),
                           ("super_mins", _F32, SUPER))),
    "q6_k": Kernel("q6_k_qmm", _Q4_SRC, "acestep_tpu/ops/pallas/qmm.py:208",
                   entry="acestep_qmm_q6_k",
                   fields=(("data", _U8, 2), ("data_hi", _U8, 4), ("sub_scales", _I8, SUB16),
                           ("super_scales", _F32, SUPER))),
}


def qmm_plain(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernels' function in plain PyTorch: ``x [M, K] @ dequant(qt) [K, N]``."""
    wd = dequantize(qt, torch.bfloat16).float()
    y = x.to(torch.bfloat16).float() @ wd
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _launch(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor],
            out_dtype) -> torch.Tensor:
    kern = KERNELS[qt.fmt]
    m, k = x.shape
    kk, n = qt.shape
    align = BLOCK if qt.fmt == "q8_0" else FOLD
    if k != kk or k % align:
        raise ValueError(f"qmm: x [{m}, {k}] against {qt.fmt} weight {qt.shape} "
                         f"(K must be a multiple of {align})")
    ptrs = []
    for field, dtype, rows_per in kern.fields:
        a = getattr(qt, field)
        if a is None or a.dtype != dtype or tuple(a.shape) != (k // rows_per, n):
            raise ValueError(
                f"qmm: {qt.fmt} field {field} must be {dtype} [{k // rows_per}, {n}] "
                "(f32 scales: pre-cast them once), got "
                f"{None if a is None else (a.dtype, tuple(a.shape))}")
        if not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"qmm: {qt.fmt} field {field} must be contiguous and on "
                             f"{x.device}")
        ptrs.append(a.data_ptr())
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmm: output dtype {out_dtype} not supported")
    x = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    bias_ptr = None
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"qmm: bias must be [{n}], got {tuple(bias.shape)}")
        bias_ptr = bias.data_ptr()
    err = getattr(_build.lib(), kern.entry)(
        x.data_ptr(), *ptrs, bias_ptr, out.data_ptr(), m, n, k,
        int(out_dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(kern.entry, err)
    kern.count((m, k, n))
    return out


def qmm(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(qt) [K, N] (+ bias) -> [M, N]`` in ``out_dtype``."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x.device}")
    return _launch(x, qt, bias, out_dtype)


def _qmm_2d(x: torch.Tensor, qt: QuantTensor, bias, out_dtype, int8_act: bool):
    if (int8_act and qt.fmt == "q8_0" and x.shape[0] <= _int8.MAX_M
            and qt.shape[1] % _int8.N_ALIGN == 0):
        y = _int8.qmm_int8_act(x, qt)
        if bias is None:
            return y.to(out_dtype)
        return (y.float() + bias.float()).to(out_dtype)
    return qmm(x, qt, bias, out_dtype)


def qmm_nd(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
           out_dtype=torch.bfloat16, int8_act: bool = False) -> torch.Tensor:
    """``[..., K] @ qt [K, N] -> [..., N]``; ``int8_act`` as the module
    docstring says."""
    lead = x.shape[:-1]
    y = _qmm_2d(x.reshape(-1, x.shape[-1]), qt, bias, out_dtype, int8_act)
    return y.reshape(*lead, qt.shape[1])


def qmm_stacked(x: torch.Tensor, qt: QuantTensor, li: int,
                bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(qt[li])``: layer ``li`` of a stacked ``[L, K, N]``
    weight, read in place (no per-layer copy)."""
    if not qt.stacked:
        raise ValueError("qmm_stacked: weight has no layer axis")
    return qmm(x, qt.layer(li), bias, out_dtype)


def qmm_stacked_nd(x: torch.Tensor, qt: QuantTensor, li: int,
                   bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16,
                   int8_act: bool = False) -> torch.Tensor:
    """``[..., K] @ dequant(qt[li])``: layer ``li`` of a stacked ``[L, K, N]``
    weight, read in place (no per-layer copy); ``int8_act`` as in
    :func:`qmm_nd`."""
    if not qt.stacked:
        raise ValueError("qmm_stacked_nd: weight has no layer axis")
    return qmm_nd(x, qt.layer(li), bias, out_dtype, int8_act)
