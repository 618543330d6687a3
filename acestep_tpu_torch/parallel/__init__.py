"""Multi-GPU serving and training on ``torch.distributed``: the (dp, tp)
mesh (:mod:`mesh`), the bootstrap and collectives, which carry gradients
(:mod:`distributed`), the tensor-parallel layout and its gather
(:mod:`sharding`), the row-parallel linears and the ring collective matmul
(:mod:`collective_matmul`), and the TP DiT entry points and training step and
the LM planner (:mod:`tp`, :mod:`lm_tp`, imported by their callers)."""

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
