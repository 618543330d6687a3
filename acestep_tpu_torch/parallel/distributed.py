"""Multi-process bootstrap and the collectives of the mesh: port of the JAX
package's parallel/distributed.py on ``torch.distributed``.

One process runs per rank.  Under ``torchrun`` the environment carries
MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK:

    from acestep_tpu_torch.parallel import distributed
    distributed.initialize()                  # NCCL over the node's cards
    mesh = distributed.global_mesh()          # (dp, tp) over every rank

A single process (no WORLD_SIZE and no ``init_method``) is not an error:
``initialize`` returns False and the entry points run unmeshed.  A
multi-process start that fails raises (the JAX package swallows the error and
goes on alone; the port does not).  The default backend is NCCL and each
rank's card is ``cuda:LOCAL_RANK``: a missing card raises.  ``initialize``
over NCCL and ``make_mesh`` make the rank's card the process's current CUDA
device, on which every kernel launches.  Several ranks on
one card, and gloo, happen only where the caller asks for them (a test, or
chip_smoke.py's one-card worlds pass ``backend="gloo"`` and ``device``).

The collectives below are what the parallel modules call.  Each keeps a fixed
order so that every rank gets the same bytes, run after run:
``all_reduce`` gathers every rank's partial and sums them in f32 in rank order,
rounding once to the partials' dtype (how XLA's CPU all-reduce rounds bf16
partials, measured on the JAX package's 8-device CPU mesh: equal bit for bit
at tp 2, 4 and 8).  Under gloo a CUDA tensor is copied to the host for the
exchange and back, explicitly.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from acestep_tpu_torch.parallel.mesh import Group, Mesh, make_mesh, mesh_shape

DEFAULT_TIMEOUT_S = 600.0


def initialize(backend: str = "nccl", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; True when there are several ranks.

    ``world_size`` / ``rank`` default to WORLD_SIZE / RANK; ``init_method`` to
    ``env://`` (MASTER_ADDR / MASTER_PORT), e.g. ``tcp://localhost:29500`` or a
    ``file://`` store.  Without a world size and an init method this is a
    single process: False.  A failed start raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_ws, env_rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    world_size = world_size if world_size is not None else (
        int(env_ws) if env_ws else None)
    rank = rank if rank is not None else (int(env_rank) if env_rank else None)
    if world_size is None and init_method is None:
        return False
    if world_size is None or rank is None:
        raise ValueError(f"initialize: world_size {world_size} and rank {rank} must both "
                         "be given (or WORLD_SIZE and RANK set)")
    if backend == "nccl":
        # NCCL binds each rank's communicator to its current device
        torch.cuda.set_device(default_device())
    try:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError, OSError) as exc:
        raise RuntimeError(f"initialize: rank {rank} of {world_size} could not join the "
                           f"{backend} process group at {init_method or 'env://'}: {exc}"
                           ) from exc
    return world_size > 1


def default_device() -> torch.device:
    """This rank's card, ``cuda:LOCAL_RANK``; raises when it does not exist."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(f"rank's card cuda:{local} does not exist "
                           f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                           " visible): pass device= to run elsewhere")
    return torch.device("cuda", local)


def topology() -> Tuple[int, int, int]:
    """(processes, ranks on this host, ranks in all) -- one card a rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return n, int(os.environ.get("LOCAL_WORLD_SIZE", n)), n


def global_mesh(device=None) -> Mesh:
    """The (dp, tp) mesh over every rank of the job: ``mesh.mesh_shape`` of
    the world size and the ranks on this host (LOCAL_WORLD_SIZE)."""
    _, local, n = topology()
    dp, tp = mesh_shape(n, local)
    return make_mesh(dp=dp, tp=tp, device=device)


def is_primary() -> bool:
    """True on the rank that logs and writes (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# collectives (a group of one is the identity)
# ---------------------------------------------------------------------------

def _staged(group: Group, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend exchanges: on the host under gloo."""
    x = x.contiguous()
    return x.cpu() if group.backend == "gloo" and x.is_cuda else x


def all_gather(x: torch.Tensor, group: Optional[Group]) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order, on ``x``'s device."""
    if group is None or group.size == 1:
        return [x]
    xs = _staged(group, x)
    # exchanged as bytes: every backend moves uint8, whatever the dtype
    flat = xs.reshape(-1).view(torch.uint8)
    out = [torch.empty_like(flat) for _ in range(group.size)]
    dist.all_gather(out, flat, group=group.pg)
    return [o.view(x.dtype).reshape(x.shape).to(x.device) for o in out]


def all_gather_cat(x: torch.Tensor, group: Optional[Group], dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (a tiled
    all-gather: column shards back into global order)."""
    parts = all_gather(x, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The sum of every rank's ``x``: f32 in rank order, rounded once to
    ``x``'s dtype; the same bytes on every rank."""
    parts = all_gather(x, group)
    if len(parts) == 1:
        return x
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(x.dtype)


def broadcast(x: torch.Tensor, group: Optional[Group], src_index: int = 0) -> torch.Tensor:
    """Group rank ``src_index``'s ``x`` on every rank (shapes equal)."""
    if group is None or group.size == 1:
        return x
    xs = _staged(group, x).clone()
    dist.broadcast(xs, src=group.ranks[src_index], group=group.pg)
    return xs.to(x.device)


def ring_exchange(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``index + shift`` and receive the same shape
    from ``index - shift`` (mod size): one hop of a ring, the send and the
    receive posted together (so no rank waits on another's receive) and both
    waited for before it returns."""
    n = group.size
    dst, src = group.ranks[(group.index + shift) % n], group.ranks[(group.index - shift) % n]
    xs = _staged(group, x)
    out = torch.empty_like(xs)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, xs, dst, group.pg),
                                   dist.P2POp(dist.irecv, out, src, group.pg)])
    for r in reqs:
        r.wait()
    return out.to(x.device)
