"""Tensor-parallel parameter layout over the (dp, tp) mesh: port of the JAX
package's parallel/sharding.py.  Where the JAX package places a global array
with a ``NamedSharding``, each rank here keeps its own shard.

Layout (the scaling-book Megatron recipe, one all-reduce per block half):
  * q/k/v, gate/up (and the serving-fused qkv/gate-up, fused rank-major by
    parallel/lm_tp.py) and ``lm_head`` kernels [K, N]: N cut over tp (column
    parallel); their biases too;
  * o_proj / down_proj kernels: K cut over tp (row parallel; the caller
    all-reduces the partial products);
  * norms, tables, embeddings and every other leaf: replicated.

A quantized weight is cut field by field: every field is [K-rows, N] (layer
stacked [L, ...]), so an N cut is exact for every format, and a K cut is
exact where each rank's K is whole blocks of the format's packing: 32 rows for
q8_0 (one scale a block), 256 for q4_0 / q4_k / q6_k (fold-256 nibbles,
q6_k's fold-64 crumbs, the 256-row super-blocks).  A weight whose cut would
split a block, or a plain one whose K the tp size does not divide, stays
whole on every rank (the JAX package's replicate rule); the row-parallel
linear (parallel/collective_matmul.py) takes such a weight as it is.  A
column-parallel weight must cut: the local head counts (``parallel.tp.local_cfg``)
rely on it, so an N the tp size does not divide raises.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from acestep_tpu_torch.parallel.mesh import Mesh
from acestep_tpu_torch.quant import QuantTensor

# qkv_proj / gateup_proj are the serving-fused weights: only valid column
# parallel when fused rank-major (parallel/lm_tp.py), so that each contiguous
# column shard is [q_r|k_r|v_r] / [gate_r|up_r]
_COL_PARALLEL = re.compile(
    r"(q_proj|k_proj|v_proj|gate_proj|up_proj|qkv_proj|gateup_proj|lm_head)/kernel$"
)
_ROW_PARALLEL = re.compile(r"(o_proj|down_proj)/kernel$")
_COL_BIAS = re.compile(r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/bias$")


def spec_for_path(path: str) -> Optional[str]:
    """"col" (cut N), "row" (cut K) or None (replicate) for a leaf's path."""
    if _COL_PARALLEL.search(path):
        return "col"
    if _ROW_PARALLEL.search(path):
        return "row"
    if _COL_BIAS.search(path):
        return "col"
    return None


def row_granule(w) -> int:
    """The K rows a row shard must hold whole: 32 for q8_0, 256 for the 4-bit
    formats and q6_k, 1 for a plain tensor."""
    if not isinstance(w, QuantTensor):
        return 1
    return 32 if w.fmt == "q8_0" else 256


def _cut(a: torch.Tensor, axis: int, tp: int, r: int) -> torch.Tensor:
    n = a.shape[axis] // tp
    return a.narrow(axis, r * n, n).contiguous()


def _check_col(n: int, tp: int) -> None:
    if n % tp:
        raise ValueError(f"column-parallel width {n} does not split over tp={tp}")


def shard_weight(w, spec: Optional[str], tp: int, r: int):
    """Rank ``r``'s shard of ``w`` under ``spec``: a row-parallel weight stays
    whole where the cut would not be exact."""
    if spec is None or tp == 1 or w is None:
        return w
    axis = -1 if spec == "col" else -2
    if isinstance(w, QuantTensor):
        k, n = w.shape
        if spec == "col":
            _check_col(n, tp)
            shape = (k, n // tp)
        elif k % tp or (k // tp) % row_granule(w) or any(
                a.shape[axis] % tp for a in w.fields().values()):
            return w
        else:
            shape = (k // tp, n)
        return QuantTensor(w.fmt, shape, **{f: _cut(a, axis, tp, r)
                                            for f, a in w.fields().items()})
    if spec == "col":
        _check_col(w.shape[-1], tp)
    elif w.shape[-2] % tp:
        return w
    return _cut(w, axis, tp, r)


def shard_params(params: Any, mesh: Mesh, path: str = "") -> Any:
    """This rank's tree of a (stacked or per-layer) parameter tree under the
    TP rules, over the mesh's tp group."""
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, f"{path}/{k}") for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, mesh, f"{path}/{i}")
                            for i, v in enumerate(params))
    if params is None:
        return None
    leaf_path = path if isinstance(params, torch.Tensor) or path.endswith("kernel") \
        else path + "/kernel"
    return shard_weight(params, spec_for_path(leaf_path), mesh.tp, mesh.tp_rank)


def shard_batch(x: Optional[torch.Tensor], mesh: Mesh, dim: int = 0):
    """This dp rank's rows of a batch (the leading axis cut into dp blocks)."""
    if x is None or mesh.dp == 1:
        return x
    if x.shape[dim] % mesh.dp:
        raise ValueError(f"batch {x.shape[dim]} does not split over dp={mesh.dp}")
    return _cut(x, dim, mesh.dp, mesh.dp_rank)


def replicate(x: Any, mesh: Mesh) -> Any:
    """A tree every rank holds whole, on this rank's device."""
    from acestep_tpu_torch.weights import tree_to

    return tree_to(x, mesh.device)
