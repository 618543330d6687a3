"""Multi-GPU serving on ``torch.distributed``: the (dp, tp) mesh
(:mod:`mesh`), the bootstrap and collectives (:mod:`distributed`), the
tensor-parallel layout (:mod:`sharding`), the row-parallel linears and the
ring collective matmul (:mod:`collective_matmul`), and the TP DiT and LM
entry points (:mod:`tp`, :mod:`lm_tp`, imported by their callers)."""

from .mesh import Mesh, TopologyTier, make_mesh, tier_for
from .sharding import replicate, shard_batch, shard_params, spec_for_path

__all__ = [
    "Mesh",
    "TopologyTier",
    "make_mesh",
    "tier_for",
    "replicate",
    "shard_batch",
    "shard_params",
    "spec_for_path",
]
