"""Row-parallel linears and the ring collective matmul: port of the JAX
package's parallel/collective_matmul.py on point-to-point sends.

A row-parallel projection (attention o_proj, MLP down_proj: the TP sites that
end in an all-reduce) computes a partial product on each rank and sums the
partials.  :func:`row_parallel_linear` does that with the fixed-order
all-reduce of ``distributed.all_reduce``, on the partial that ``linear`` (the
qmm kernels on the card) returns.

A weight that :mod:`sharding` left whole (its K cut would split a quant
block) meets the local activations [..., K / tp]: the activations are gathered
in rank order and the whole product computed on every rank, with no
reduction.  Both carry gradients (``distributed``): the sum passes its
gradient on to every partial, the gather gives each rank its slice.

:func:`allreduce_matmul` is the JAX package's scaling-book ring on a plain
2-D weight: the output axis cut into one chunk a rank, each chunk's partial
travelling the ring once (reduce-scatter) and the summed chunks travelling it
again (all-gather).  Each hop here waits for its exchange before the next
chunk's product, so nothing overlaps; each output element is summed in a
fixed rank order (from the rank after its chunk's owner), so it is
deterministic and differs from the all-reduce by float reassociation only.
No serving path routes through it: the JAX package runs it only behind
``ACESTEP_TPU_COLLECTIVE_MATMUL=1`` and never for its layer-stacked quantized
weights, which are every weight of the served DiT and planner.
"""

from __future__ import annotations

from typing import Optional

import torch

from acestep_tpu_torch.ops.qlinear import StackedWeight, linear
from acestep_tpu_torch.parallel.distributed import all_gather_cat, all_reduce, ring_exchange
from acestep_tpu_torch.parallel.mesh import Group
from acestep_tpu_torch.quant import QuantTensor


def reduce_scatter_matmul(x: torch.Tensor, w: torch.Tensor, group: Group) -> torch.Tensor:
    """x [..., K_local] @ w [K_local, N] summed over the group, ring
    reduce-scatter: returns [..., N / n], this rank's output chunk.

    The accumulator for chunk c starts on the rank after c's owner and hops to
    the previous rank n - 1 times, each rank adding its partial for the chunk
    it holds: at step s rank r adds chunk (r + s + 1) mod n."""
    n, r = group.size, group.index
    nn = w.shape[-1]
    if nn % n:
        raise ValueError(f"output dim {nn} not divisible by the group size {n}")
    chunk = nn // n

    def partial_for(step):
        c = (r + step + 1) % n
        return torch.matmul(x.float(), w[:, c * chunk:(c + 1) * chunk].to(x.dtype).float())

    acc = partial_for(0)
    for s in range(1, n):
        acc = ring_exchange(acc, group, -1) + partial_for(s)
    return acc.to(x.dtype)


def allgather_chunks(y_local: torch.Tensor, group: Group) -> torch.Tensor:
    """Ring all-gather of per-rank output chunks -> the full output, chunks in
    rank order along the last axis (n - 1 hops to the next rank)."""
    n, r = group.size, group.index
    chunk = y_local.shape[-1]
    out = torch.empty(y_local.shape[:-1] + (n * chunk,), dtype=y_local.dtype,
                      device=y_local.device)
    out[..., r * chunk:(r + 1) * chunk] = y_local
    piece = y_local
    for s in range(1, n):
        piece = ring_exchange(piece, group, 1)
        owner = (r - s) % n
        out[..., owner * chunk:(owner + 1) * chunk] = piece
    return out


def allreduce_matmul(x: torch.Tensor, w: torch.Tensor, group: Group) -> torch.Tensor:
    """``all_reduce(x @ w)`` as a ring reduce-scatter then a ring all-gather."""
    return allgather_chunks(reduce_scatter_matmul(x, w, group), group)


def _rows(w) -> int:
    if isinstance(w, StackedWeight):
        w = w.w
    return w.shape[0] if isinstance(w, QuantTensor) else int(w.shape[-2])


def row_parallel_linear(x: torch.Tensor, w, group: Optional[Group], int8_act: bool = False
                        ) -> torch.Tensor:
    """``all_reduce(linear(x, w))`` of a row-parallel projection over
    ``group``: x [..., K / tp] is this rank's slice of the input features and
    w its rows (``linear`` itself without a group); a whole weight gathers the
    activations instead (module docstring)."""
    if group is None:
        return linear(x, w, int8_act=int8_act)
    if _rows(w) != x.shape[-1]:
        return linear(all_gather_cat(x, group), w, int8_act=int8_act)
    return all_reduce(linear(x, w, int8_act=int8_act), group)
