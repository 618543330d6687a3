"""LoRA adapters: port of the JAX package's training/lora.py (init, merge,
scale and the LoRA train step).

An adapter tree mirrors the DiT's unstacked parameter tree and holds
``{"a": [K, r], "b": [r, N]}`` in place of each targeted kernel (None
elsewhere); the merged weight is ``W + (alpha / r) * a @ b``.  A bf16 (or f32)
kernel adds the f32 delta and rounds once to its dtype.  A quantized kernel is
dequantized to f32, the delta added, and the sum requantized in the kernel's
own format with the port's quantizers (``quant.quantize``, bit-exact with the
JAX package's numpy ones), wherever the kernel lies; its float fields keep
their dtype.

Serving (:func:`apply_lora`) sums the delta in f32 in a fixed order, so a
merge on the card equals the same merge on the CPU bit for bit.  Training
(:func:`make_lora_train_step`) merges with one f32 product ``a @ b``, as the
JAX step does, on every step and under grad: with a bf16 base the delta is
rounded into the bf16 weight and the gradient passes through that cast.  A
quantized base passes the gradient only through what the requantization
keeps differentiable (each block's scale, through its absolute maximum), in
both packages; on the card the dequant-matmul kernels have no backward, so
the step refuses a quantized CUDA base.  The base stays frozen; on a
non-finite gradient the adapter is kept but the optimizer state advances (the
update runs on zeroed gradients), as in the JAX step.  Training takes the
unfused per-layer tree; serving's fused, stacked tree is rebuilt from the
merged one (``lora_runtime``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict

import torch

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.quant import QuantTensor, dequantize, quantize
from acestep_tpu_torch.training.flow_matching import (
    flow_matching_loss, guarded_step, loss_params)
from acestep_tpu_torch.weights import tree_leaves, walk

# default targets: every attention / MLP projection
DEFAULT_TARGETS = re.compile(
    r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$")


def kernel_shape(leaf):
    """(K, N) of a 2-D kernel (tensor or QuantTensor), else None."""
    if isinstance(leaf, QuantTensor):
        return tuple(leaf.shape)
    if isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
        return tuple(leaf.shape)
    return None


def init_lora(generator: torch.Generator, params: Any, rank: int = 16,
              targets: re.Pattern = DEFAULT_TARGETS, dtype=torch.float32) -> Any:
    """An adapter tree for ``params``: ``a ~ N(0, 1) / rank``, ``b = 0`` (the
    adapter starts as a no-op), drawn from ``generator`` on its device in the
    order of the tree."""
    def make(path: str, leaf):
        shape = kernel_shape(leaf)
        if targets.search(path) is None or shape is None:
            return None
        k, n = shape
        a = torch.randn((k, rank), generator=generator, device=generator.device) / rank
        return {"a": a.to(dtype), "b": torch.zeros((rank, n), dtype=dtype,
                                                   device=generator.device)}

    return walk(params, make)


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


def merge_delta(w, delta: torch.Tensor):
    """``w`` plus an f32 delta: one rounding to a float kernel's dtype, or a
    requantization in a QuantTensor's format (float fields in their dtypes)."""
    if isinstance(w, QuantTensor):
        merged = quantize(dequantize(w, torch.float32) + delta, w.fmt)
        return QuantTensor(w.fmt, w.shape, **{
            f: a.to(getattr(w, f).dtype) for f, a in merged.fields().items()})
    return (w.float() + delta).to(w.dtype)


def _weight_device(w):
    return w.data.device if isinstance(w, QuantTensor) else w.device


def merge_tree(params: Any, adapter: Any, delta_fn: Callable[[Any, Any], torch.Tensor]) -> Any:
    """``params`` with ``merge_delta(W, delta_fn(W, leaf))`` at each kernel
    the adapter holds a leaf ``{"a", "b"}`` for.  ``adapter`` may lack subtrees
    (one read from disk keeps only its arrays); untouched leaves are the same
    objects."""

    def go(pp, ll):
        if isinstance(pp, dict):
            def sub(k):
                return ll.get(k) if isinstance(ll, dict) else None

            return {k: (merge_delta(pp[k], delta_fn(pp[k], sub(k)))
                        if _is_lora_leaf(sub(k)) and _is_weight(pp[k]) else go(pp[k], sub(k)))
                    for k in pp}
        if isinstance(pp, (list, tuple)):
            return type(pp)(
                go(v, ll[i] if isinstance(ll, (list, tuple)) and i < len(ll) else None)
                for i, v in enumerate(pp))
        return pp

    return go(params, adapter)


def apply_lora(params: Any, lora: Any, alpha: float = 16.0) -> Any:
    """``params`` with each adapter delta merged into its kernel (the delta of
    :func:`lora_delta`, summed in order on the kernel's device)."""
    return merge_tree(params, lora, lambda w, ll: lora_delta(
        ll, alpha, ll["a"].shape[1], device=_weight_device(w)))


def scale_lora(lora: Any, factor: float) -> Any:
    """The adapter at ``factor`` times its strength (``b`` scaled)."""

    def scale(t):
        if isinstance(t, dict):
            if _is_lora_leaf(t):
                return {"a": t["a"], "b": t["b"] * factor}
            return {k: scale(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(scale(v) for v in t)
        return t

    return scale(lora)


# ---------------------------------------------------------------------------
# LoRA flow-matching training
# ---------------------------------------------------------------------------

def train_delta(ll: Dict[str, torch.Tensor], alpha: float) -> torch.Tensor:
    """``(alpha / r) * a @ b`` as one f32 product (the JAX step's delta)."""
    return (alpha / ll["a"].shape[1]) * (ll["a"].float() @ ll["b"].float())


def check_trainable_base(base: Any) -> None:
    """Refuse a quantized kernel on the card under an adapter step: the
    dequant-matmul kernels have no backward."""
    for leaf in tree_leaves(base):
        if isinstance(leaf, QuantTensor) and leaf.data.device.type == "cuda":
            raise ValueError("adapter training on the card needs a float base: the "
                             "dequant-matmul kernels have no backward")


def make_lora_train_step(base_params: Any, cfg: DiTConfig, optimizer, alpha: float = 16.0):
    """``step(lora, opt_state, batch, t, noise) -> (lora, opt_state, loss)``
    over the adapter only (the base frozen), with the flow-matching loss and
    the adapter guard (module docstring).  The merge covers the groups the loss
    reads; the encoders' adapter leaves get zero gradients, as in JAX."""
    base = loss_params(base_params)
    check_trainable_base(base)

    def step(lora, opt_state, batch, t, noise):
        def loss_of(tree):
            merged = merge_tree(base, tree, lambda w, ll: train_delta(ll, alpha))
            return flow_matching_loss(merged, cfg, batch, t, noise)

        return guarded_step(loss_of, lora, opt_state, optimizer, keep_state=False)

    return step
