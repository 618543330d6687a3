"""The (dp, tp) process mesh and the topology tiers: port of the JAX package's
parallel/mesh.py on ``torch.distributed``.

The JAX package drives one controller over a device mesh; here one process
runs per rank (SPMD): every rank calls the same entry point with the same
request and returns the same result.  Axes:

  dp  data parallel: a batch is split into dp row blocks (independent songs);
  tp  tensor parallel: attention heads and MLP columns (Megatron layout).

Ranks are laid out dp-major, as ``np.asarray(devices).reshape(dp, tp)`` lays
out the JAX package's devices: rank r sits at (r // tp, r % tp), so each tp
group is a run of consecutive ranks (one host's cards under torchrun).

The tier table is the JAX package's, copied as it stands: given a device
count, it picks (dp, tp).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TopologyTier:
    n_devices: int
    dp: int
    tp: int
    max_batch: int
    max_duration_s: float


# defaults per device count -- TP covers the DiT's 16 attention heads (so tp <= 8
# keeps >= 2 heads per shard and divides the 8 KV heads evenly)
TIERS = {
    1: TopologyTier(1, dp=1, tp=1, max_batch=8, max_duration_s=600.0),
    2: TopologyTier(2, dp=1, tp=2, max_batch=8, max_duration_s=600.0),
    4: TopologyTier(4, dp=1, tp=4, max_batch=8, max_duration_s=600.0),
    8: TopologyTier(8, dp=2, tp=4, max_batch=16, max_duration_s=600.0),
    16: TopologyTier(16, dp=4, tp=4, max_batch=32, max_duration_s=600.0),
    32: TopologyTier(32, dp=8, tp=4, max_batch=64, max_duration_s=600.0),
}


def tier_for(n_devices: int) -> TopologyTier:
    if n_devices in TIERS:
        return TIERS[n_devices]
    # fall back: tp = gcd-ish largest power of two <= 8 dividing n
    tp = 1
    for cand in (8, 4, 2):
        if n_devices % cand == 0:
            tp = cand
            break
    return TopologyTier(n_devices, dp=n_devices // tp, tp=tp,
                        max_batch=8 * n_devices, max_duration_s=600.0)


def mesh_shape(n_devices: int, local_devices: int) -> Tuple[int, int]:
    """(dp, tp) for ``n_devices`` ranks, ``local_devices`` of them on each
    host: the tier's tp clamped to one host's ranks (a tp group never crosses
    hosts, as the JAX package clamps tp to its local devices), then dp the
    rest."""
    tp = min(tier_for(n_devices).tp, local_devices)
    while tp > 1 and local_devices % tp:
        tp -= 1
    return n_devices // tp, tp


@dataclasses.dataclass
class Group:
    """One group of the mesh: its global ranks in order, this rank's index in
    it, and the process group (None for a group of one, whose collectives are
    the identity)."""

    ranks: List[int]
    index: int
    pg: Optional[object]
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (dp, tp) mesh: its coordinates, its tp group
    (the ranks that share its dp row), its dp group (the ranks that share its
    tp column), the whole world, the backend and this rank's device."""

    dp: int
    tp: int
    rank: int
    tp_group: Group
    dp_group: Group
    world: Group
    backend: str
    device: torch.device

    @property
    def world_size(self) -> int:
        return self.dp * self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, device=None) -> Mesh:
    """The (dp, tp) mesh over the initialized process group's ranks (see
    ``distributed.initialize``).  ``dp`` / ``tp`` default to the tier table's;
    ``device`` to this rank's (``distributed.default_device``), which becomes
    the process's current CUDA device: the kernels launch on the current
    device, so each rank's must be its own.  Every rank must call this
    together: ``dist.new_group`` is collective over the world."""
    from acestep_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if tp is None:
        tp = n // dp if dp else tier_for(n).tp
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({n})")
    backend = dist.get_backend()
    device = distributed.default_device() if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    groups = {}
    # every rank creates every group, in one order (new_group is collective)
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        g = dist.new_group(ranks) if tp > 1 else None
        if rank in ranks:
            groups["tp"] = Group(ranks, ranks.index(rank), g, backend, device)
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            groups["dp"] = Group(ranks, ranks.index(rank), g, backend, device)
    world = Group(list(range(n)), rank, dist.group.WORLD if n > 1 else None, backend, device)
    return Mesh(dp, tp, rank, groups["tp"], groups["dp"], world, backend, device)
