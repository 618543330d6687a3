"""Parameter trees from the JAX package into the port.

:func:`from_jax_numpy` takes one of the JAX package's parameter trees (nested
dicts/lists) whose array leaves are numpy arrays (any array with
``__array__``) and whose quantized weights are QuantTensor-like objects
(``fmt``, ``shape`` and the field attributes ``data``, ``data_hi``, ``scales``,
``sub_scales``, ``sub_mins``, ``super_scales``, ``super_mins``), and returns the
same tree with torch tensors and :class:`acestep_tpu_torch.quant.QuantTensor`
leaves (every field of every format carried across).  The
layouts are the same in both packages, so the port computes the same function
on the converted tree.  No JAX import is needed: leaves are read through numpy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from acestep_tpu_torch.quant import FIELDS, QuantTensor


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # numpy has no bf16 of its own
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def from_jax_numpy(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device) for v in tree)
    if tree is None:
        return None
    if hasattr(tree, "fmt"):
        return QuantTensor(tree.fmt, tuple(int(s) for s in tree.shape),
                           **{f: _tensor(getattr(tree, f), device) for f in FIELDS
                              if getattr(tree, f, None) is not None})
    return _tensor(tree, device)


def tree_to(tree, device):
    """Move every tensor of a parameter tree (QuantTensors included) to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, QuantTensor):
        return tree.to(device)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# tree helpers (nested dicts / lists / tuples; a None leaf is an untargeted slot)
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves in insertion order (None skipped)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with its tensor leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(like)


def tree_map(fn, tree) -> Any:
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def walk(tree: Any, fn: Callable[[str, Any], Any], path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn("/a/0/b", leaf)``."""
    if isinstance(tree, dict):
        return {k: walk(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(v, fn, f"{path}/{i}") for i, v in enumerate(tree))
    return fn(path, tree)


def flatten(tree: Any, path: str = "") -> Dict[str, Any]:
    """``{"a/0/b": leaf}``: the leaves by their checkpoint names."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{path}/{k}" if path else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{path}/{i}"))
    else:
        out[path] = tree
    return out
