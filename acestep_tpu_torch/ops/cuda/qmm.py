"""q8_0 dequant-matmul: CUDA kernel wrapper, its plain PyTorch version and the
2-D / n-D / layer-stacked entry points.

Kernel: ``csrc/qmm_q8_0.cu`` (hand-written for sm_90a, WMMA bf16 tensor cores).
It replaces the Pallas kernel ``acestep_tpu/ops/pallas/qmm.py:147 _q8_kernel``
reached through ``qmm_pallas`` / ``qmm_pallas_nd`` and, for the DiT's
layer-stacked weights, ``qmm_pallas_stacked`` (scalar-prefetched layer index):
here the stacked form passes the base pointers of layer ``li`` to the same
kernel, so no per-layer weight copy is made either.

Bound on the H100: bytes at the main path's shapes (M = 1..320 rows; an int8
weight byte feeds 2*M flops, below the card's ~295 flop/byte balance).  The
kernel streams int8 weights and dequantizes them in shared memory, so device
memory never holds a bf16 copy of W.

Numerics (the JAX package's, qmm.py:18-19): dequant in f32, one rounding to
bf16, f32 accumulation; the bias is added in f32 before the one output rounding.

Dispatch: a CPU tensor takes :func:`qmm_plain`; a CUDA tensor launches the
kernel or raises.  ``launches`` counts kernel launches; ``shapes`` counts them
by ``(M, K, N)``, so a run can show which shapes its path used.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.quant import BLOCK, QuantTensor, dequantize

NAME = "q8_0_qmm"
SOURCE = "acestep_tpu_torch/csrc/qmm_q8_0.cu"
REPLACES = "acestep_tpu/ops/pallas/qmm.py:147"

launches = 0
shapes: Counter = Counter()      # (M, K, N) -> launches at that shape


def reset_counts() -> None:
    global launches
    launches = 0
    shapes.clear()


def qmm_plain(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x [M, K] @ dequant(qt) [K, N]``."""
    wd = dequantize(qt, torch.bfloat16).float()
    y = x.to(torch.bfloat16).float() @ wd
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _launch(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor],
            out_dtype) -> torch.Tensor:
    global launches
    m, k = x.shape
    kk, n = qt.shape
    if k != kk or k % BLOCK:
        raise ValueError(f"qmm: x [{m}, {k}] against q8_0 weight {qt.shape}")
    data, scales = qt.data, qt.scales
    if data.dim() != 2 or tuple(data.shape) != (k, n) or data.dtype != torch.int8:
        raise ValueError(f"qmm: weight data must be int8 [{k}, {n}], got "
                         f"{data.dtype} {tuple(data.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (k // BLOCK, n):
        raise ValueError("qmm: scales must be f32 [K/32, N] (pre-cast them once; "
                         f"got {scales.dtype} {tuple(scales.shape)})")
    if not (data.is_contiguous() and scales.is_contiguous()):
        raise ValueError("qmm: weight data and scales must be contiguous")
    if data.device != x.device or scales.device != x.device:
        raise ValueError("qmm: x and the weight must lie on the same device")
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
    err = _build.lib().acestep_qmm_q8_0(
        x.data_ptr(), data.data_ptr(), scales.data_ptr(), bias_ptr, out.data_ptr(),
        m, n, k, int(out_dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check("acestep_qmm_q8_0", err)
    launches += 1
    shapes[(m, k, n)] += 1
    return out


def qmm(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(qt) [K, N] (+ bias) -> [M, N]`` in ``out_dtype``."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x.device}")
    return _launch(x, qt, bias, out_dtype)


def qmm_nd(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
           out_dtype=torch.bfloat16) -> torch.Tensor:
    """``[..., K] @ qt [K, N] -> [..., N]``."""
    lead = x.shape[:-1]
    y = qmm(x.reshape(-1, x.shape[-1]), qt, bias, out_dtype)
    return y.reshape(*lead, qt.shape[1])


def qmm_stacked(x: torch.Tensor, qt: QuantTensor, li: int,
                bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(qt[li])``: layer ``li`` of a stacked ``[L, K, N]``
    weight, read in place (no per-layer copy)."""
    if not qt.stacked:
        raise ValueError("qmm_stacked: weight has no layer axis")
    return qmm(x, qt.layer(li), bias, out_dtype)


def qmm_stacked_nd(x: torch.Tensor, qt: QuantTensor, li: int,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    lead = x.shape[:-1]
    y = qmm_stacked(x.reshape(-1, x.shape[-1]), qt, li, bias, out_dtype)
    return y.reshape(*lead, qt.shape[1])
