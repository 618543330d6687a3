"""q8_0 block-quant format in the JAX package's kernel layout.

A weight is stored as ``[K, N]`` (contraction axis first, ``y = x @ W``):
int8 values ``data [K, N]`` and one scale per 32-row block ``scales [K/32, N]``
(fp16 on disk; the engine pre-casts them to f32 once, because the CUDA kernel
reads f32 scales).  Layer-stacked weights carry a leading layer axis on both
fields (``[L, K, N]`` / ``[L, K/32, N]``) while ``shape`` stays the logical
``(K, N)``.

Numerics match the reference quantizer: ``d = amax/127``, ``q = round(x/d)``
with round-half-away-from-zero; dequant is ``f32(q) * f32(d)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

BLOCK = 32       # elements per quant block (scale granularity along K)


@dataclasses.dataclass
class QuantTensor:
    """A q8_0 weight in kernel layout ``[K, N]`` (or stacked ``[L, K, N]``)."""

    fmt: str
    shape: Tuple[int, int]            # logical (K, N)
    data: torch.Tensor                # int8 [K, N] or [L, K, N]
    scales: torch.Tensor              # f16/f32 [K/32, N] or [L, K/32, N]

    def __post_init__(self):
        if self.fmt != "q8_0":
            raise ValueError(f"the port supports q8_0 only, got {self.fmt}")

    @property
    def stacked(self) -> bool:
        return self.data.dim() == 3

    @property
    def num_layers(self) -> int:
        return self.data.shape[0] if self.stacked else 1

    def layer(self, li: int) -> "QuantTensor":
        """View of layer ``li`` of a stacked weight (no copy)."""
        return QuantTensor(self.fmt, self.shape, self.data[li], self.scales[li])

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.fmt, self.shape, self.data.to(device), self.scales.to(device))


def _roundf(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C roundf); torch.round rounds half to even."""
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


def quantize_q8_0(w: torch.Tensor) -> QuantTensor:
    """``w [K, N]`` (any float dtype, any device) -> q8_0 QuantTensor on the same
    device, fp16 scales.  Runs where ``w`` lies, so a random engine is built and
    quantized on the card one tensor at a time."""
    if w.dim() != 2:
        raise ValueError(f"expected 2-D kernel [K, N], got shape {tuple(w.shape)}")
    k, n = w.shape
    if k % BLOCK:
        raise ValueError(f"q8_0 requires K % {BLOCK} == 0, got K={k}")
    blocks = w.float().reshape(k // BLOCK, BLOCK, n)
    d = blocks.abs().amax(dim=1) / 127.0                     # [K/32, N]
    inv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), torch.zeros_like(d))
    q = _roundf(blocks * inv[:, None, :]).clamp(-127, 127).to(torch.int8)
    return QuantTensor("q8_0", (k, n), q.reshape(k, n), d.to(torch.float16))


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the weight ``[K, N]`` (``[L, K, N]`` if stacked) in ``dtype``:
    dequant in f32, one rounding to ``dtype``."""
    scales = torch.repeat_interleave(qt.scales.float(), BLOCK, dim=-2)
    return (qt.data.float() * scales).to(dtype)


def concat_n(qts) -> QuantTensor:
    """Concatenate q8_0 weights along N (exact column-for-column: blocks run
    along K).  Used to fuse q||k||v and gate||up into one weight stream."""
    return QuantTensor(
        "q8_0", (qts[0].shape[0], sum(q.shape[1] for q in qts)),
        torch.cat([q.data for q in qts], dim=-1),
        torch.cat([q.scales for q in qts], dim=-1),
    )
