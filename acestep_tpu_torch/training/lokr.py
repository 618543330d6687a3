"""LoKr adapters (Kronecker-product fine-tuning): port of the JAX package's
training/lokr.py.

The weight delta is ``alpha * kron(A, B)`` with ``A [k1, n1]``, ``B [k2, n2]``,
``k1 * k2 = K`` and ``n1 * n2 = N`` (no division by a rank).  Init: A small
normal, B zero (a no-op start).  Merging, the quantized-base rule and the
train step's guard are LoRA's (training/lora.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.training.flow_matching import (
    flow_matching_loss, guarded_step, loss_params)
from acestep_tpu_torch.training.lora import (
    DEFAULT_TARGETS, check_trainable_base, kernel_shape, merge_tree)
from acestep_tpu_torch.weights import walk


def _factor_dim(n: int, target: int) -> Tuple[int, int]:
    """n = a * b with a as close to ``target`` as possible (the smaller a on ties)."""
    best = (1, n)
    for a in range(1, int(n ** 0.5) + 1):
        if n % a == 0 and abs(a - target) < abs(best[0] - target):
            best = (a, n // a)
    return best


def init_lokr(generator: torch.Generator, params: Any, factor: int = 8,
              targets: re.Pattern = DEFAULT_TARGETS, dtype=torch.float32) -> Any:
    """``{"a": [k1, n1] ~ 0.1 N(0, 1), "b": zeros [k2, n2]}`` per targeted kernel,
    drawn from ``generator`` on its device in the order of the tree."""
    def make(path: str, leaf):
        shape = kernel_shape(leaf)
        if targets.search(path) is None or shape is None:
            return None
        (k1, k2), (n1, n2) = _factor_dim(shape[0], factor), _factor_dim(shape[1], factor)
        a = torch.randn((k1, n1), generator=generator, device=generator.device) * 0.1
        return {"a": a.to(dtype),
                "b": torch.zeros((k2, n2), dtype=dtype, device=generator.device)}

    return walk(params, make)


def lokr_delta(leaf: Dict[str, torch.Tensor], alpha: float) -> torch.Tensor:
    return alpha * torch.kron(leaf["a"].float(), leaf["b"].float())


def apply_lokr(params: Any, lokr: Any, alpha: float = 1.0) -> Any:
    """``params`` with each LoKr delta merged (quantized kernels requantized)."""
    return merge_tree(params, lokr, lambda w, ll: lokr_delta(ll, alpha))


def make_lokr_train_step(base_params: Any, cfg: DiTConfig, optimizer, alpha: float = 1.0):
    """``step(lokr, opt_state, batch, t, noise) -> (lokr, opt_state, loss)``,
    the base frozen, guarded as the LoRA step."""
    base = loss_params(base_params)
    check_trainable_base(base)

    def step(lokr, opt_state, batch, t, noise):
        return guarded_step(
            lambda tree: flow_matching_loss(apply_lokr(base, tree, alpha), cfg, batch, t, noise),
            lokr, opt_state, optimizer, keep_state=False)

    return step
