#!/usr/bin/env python3
"""The meshed training step's gradients against one process's, with the
port's bf16 casts turned into f32 so that only summation order parts them.

    python3 tools/tp_grad_f32.py [--meshes 1x2 2x2 1x4]

On the CPU (gloo, one process a rank).  A small float64 DiT (per-layer lists,
the groups the loss reads) and a batch of two whose second item's last 9
frames are out of the loss; each mesh's ranks take their shards and dp rows,
run ``flow_matching_loss`` with the tp and dp groups, sum the gradients over
dp (``flow_matching.sum_over``) and gather the tree (``unshard_params``);
rank 0 prints the loss and the largest per-leaf max error over the leaf's
peak against the same loss's gradients in this process.  With bf16 in place
the two part by the rounding of the products each rank runs at its own
shapes; with it gone they part by reassociation alone, which is what this
shows about the collectives' adjoints (``distributed.copy_to_group``,
``all_reduce``, ``all_gather_cat``), the q / k norms' partial gradients and
the loss's whole-batch mask count.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
torch.bfloat16 = torch.float32      # every bf16 cast of the port becomes f32, in every rank too

import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from acestep_tpu_torch import weights  # noqa: E402
from acestep_tpu_torch.config import DiTConfig  # noqa: E402
from acestep_tpu_torch.models.random_init import RandomInit  # noqa: E402
from acestep_tpu_torch.models.stacking import unstack_layer_params  # noqa: E402
from acestep_tpu_torch.training import flow_matching as fm  # noqa: E402

CFG = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=8, num_key_value_heads=4, head_dim=32, in_channels=24,
                audio_acoustic_hidden_dim=8, sliding_window=8, text_hidden_dim=64,
                num_lyric_encoder_hidden_layers=0, num_timbre_encoder_hidden_layers=0)
B, T, LC = 2, 40, 12


def inputs():
    """(loss groups of a float64 DiT drawn from seed 3, batch, t, noise)."""
    tree = RandomInit(torch.device("cpu"), 3, None, dtype=torch.float64).dit(CFG)
    tree["layers"] = unstack_layer_params(tree["layers"])
    rng = np.random.default_rng(0)
    batch = {"latents": rng.standard_normal((B, T, 8)),
             "context_latents": rng.standard_normal((B, T, CFG.context_dim)),
             "encoder_hidden_states": rng.standard_normal((B, LC, CFG.hidden_size)),
             "loss_mask": np.ones((B, T))}
    batch["loss_mask"][1, -9:] = 0.0
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    t = torch.tensor([0.7, 0.3], dtype=torch.float64)
    noise = torch.from_numpy(rng.standard_normal((B, T, 8)))
    return fm.loss_params(tree), batch, t, noise


def loss_and_grads(tree, batch, t, noise, cfg=CFG, **groups):
    leaves = [x.detach().requires_grad_() for x in weights.tree_leaves(tree)]
    loss = fm.flow_matching_loss(weights.tree_unflatten(tree, leaves), cfg, batch, t, noise,
                                 **groups)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for x, g in zip(leaves, grads)]


def rank_main(rank, dp, tp, store, queue):
    from acestep_tpu_torch.parallel import distributed, make_mesh, shard_params
    from acestep_tpu_torch.parallel.sharding import shard_batch, unshard_params
    from acestep_tpu_torch.parallel.tp import local_cfg

    torch.set_default_dtype(torch.float64)
    distributed.initialize("gloo", "file://" + store, dp * tp, rank)
    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    tree, batch, t, noise = inputs()
    local = shard_params(tree, mesh)
    loss, grads = loss_and_grads(
        local, {k: shard_batch(v, mesh) for k, v in batch.items()}, shard_batch(t, mesh),
        shard_batch(noise, mesh), cfg=local_cfg(CFG, tp), group=mesh.tp_group,
        dp_group=mesh.dp_group)
    grads = fm.sum_over(grads, mesh.dp_group)
    loss = float(distributed.all_reduce(loss, mesh.dp_group))
    whole = unshard_params(weights.tree_unflatten(local, grads), mesh)
    if rank == 0:
        queue.put((loss, {n: v.numpy() for n, v in weights.flatten(whole).items()}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", nargs="+", default=["1x2", "2x2", "1x4"])
    args = ap.parse_args()
    torch.set_default_dtype(torch.float64)
    loss, grads = loss_and_grads(*inputs())
    tree = inputs()[0]
    ref = {n: v.numpy() for n, v in weights.flatten(weights.tree_unflatten(tree, grads)).items()}
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as work:
        for tag in args.meshes:
            dp, tp = (int(x) for x in tag.split("x"))
            queue = ctx.Queue()
            procs = [ctx.Process(target=rank_main,
                                 args=(r, dp, tp, os.path.join(work, f"store{tag}"), queue))
                     for r in range(dp * tp)]
            for p in procs:
                p.start()
            got_loss, got = queue.get(timeout=600)
            for p in procs:
                p.join(timeout=60)
            worst = max((float(np.abs(got[n] - v).max() / (np.abs(v).max() + 1e-300)), n)
                        for n, v in ref.items())
            print(f"({dp}, {tp}): loss {got_loss:.17g} against {float(loss):.17g} (rel "
                  f"{abs(got_loss - float(loss)) / float(loss):.2e}); gradients: the largest "
                  f"per-leaf max error over the peak {worst[0]:.2e} ({worst[1]}), "
                  f"{len(ref)} leaves", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
