"""LoRA adapters, the merge half: port of the JAX package's training/lora.py
(``lora_delta``, ``apply_lora``, ``scale_lora``).  Initialisation and the
LoRA train step wait for the training slice.

An adapter tree mirrors the DiT's unstacked parameter tree and holds
``{"a": [K, r], "b": [r, N]}`` in place of each targeted kernel; the merged
weight is ``W + (alpha / r) * a @ b``.  A bf16 (or f32) kernel adds the f32
delta and rounds once to its dtype.  A quantized kernel is dequantized to f32,
the delta added, and the sum requantized in the kernel's own format with the
port's quantizers (``quant.quantize``, bit-exact with the JAX package's numpy
ones), wherever the kernel lies; its float fields keep their dtype.  The
delta is summed in f32 in a fixed order, so a merge on the card equals the
same merge on the CPU bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from acestep_tpu_torch.quant import QuantTensor, dequantize, quantize


def lora_delta(lora_leaf: Dict[str, torch.Tensor], alpha: float, rank: int,
               device=None) -> torch.Tensor:
    """``(alpha / rank) * a @ b`` in f32 on ``device`` (the adapter's own by
    default).  The product is summed over the rank in order, one rounding per
    multiply and per add (no TF32, no FMA), so the card and the CPU make the
    same delta bit for bit and a merge on either requantizes alike."""
    a = lora_leaf["a"].to(device=device, dtype=torch.float32)
    b = lora_leaf["b"].to(device=device, dtype=torch.float32)
    acc = a[:, :1] * b[:1]
    for r in range(1, a.shape[1]):
        acc = acc + a[:, r:r + 1] * b[r:r + 1]
    return (alpha / rank) * acc


def _is_lora_leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"a", "b"}


def _is_weight(x) -> bool:
    return isinstance(x, QuantTensor) or (isinstance(x, torch.Tensor) and x.dim() == 2)


def _merge(w, ll, alpha: float):
    rank = ll["a"].shape[1]
    if isinstance(w, QuantTensor):
        delta = lora_delta(ll, alpha, rank, device=w.data.device)
        merged = quantize(dequantize(w, torch.float32) + delta, w.fmt)
        return QuantTensor(w.fmt, w.shape, **{
            f: a.to(getattr(w, f).dtype) for f, a in merged.fields().items()})
    delta = lora_delta(ll, alpha, rank, device=w.device)
    return (w.float() + delta).to(w.dtype)


def apply_lora(params: Any, lora: Any, alpha: float = 16.0) -> Any:
    """``params`` with each adapter delta merged into its kernel.  ``lora``
    may lack subtrees (an adapter read from disk keeps only its arrays);
    untouched leaves are the same objects."""

    def walk(pp, ll):
        if isinstance(pp, dict):
            def sub(k):
                return ll.get(k) if isinstance(ll, dict) else None

            return {k: (_merge(pp[k], sub(k), alpha)
                        if _is_lora_leaf(sub(k)) and _is_weight(pp[k]) else walk(pp[k], sub(k)))
                    for k in pp}
        if isinstance(pp, (list, tuple)):
            return type(pp)(
                walk(v, ll[i] if isinstance(ll, (list, tuple)) and i < len(ll) else None)
                for i, v in enumerate(pp))
        return pp

    return walk(params, lora)


def scale_lora(lora: Any, factor: float) -> Any:
    """The adapter at ``factor`` times its strength (``b`` scaled)."""

    def walk(t):
        if isinstance(t, dict):
            if _is_lora_leaf(t):
                return {"a": t["a"], "b": t["b"] * factor}
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(lora)
