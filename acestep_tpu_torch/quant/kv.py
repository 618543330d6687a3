"""Per-vector quantization of K/V rows (the KV cache's store format, shared by
serving/kv_cache.py and the decode kernels' plain versions).

int8: ``s = amax / 127``, ``q = round_half_even(x / s)`` clipped to +-127;
fp8 (float8_e4m3fn): ``s = amax / 448``, ``q = cast(x / s)``.  Both dequantize
as ``q * s``.
"""

from __future__ import annotations

from typing import Tuple

import torch

FP8_MAX = 448.0                  # float8_e4m3fn largest finite value
KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def check_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}: expected 'int8' or 'fp8'")
    return kv_dtype


def quantize_kv(x: torch.Tensor, kv_dtype: str = "int8") -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., D]`` -> (int8 / fp8 values, f32 scale over the last axis)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    full = FP8_MAX if check_kv_dtype(kv_dtype) == "fp8" else 127.0
    scale = amax / full
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    if kv_dtype == "fp8":
        q = torch.clamp(xf * inv[..., None], -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
        return q, scale
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, scale
