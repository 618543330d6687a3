"""Tensor-parallel DiT entry points over the (dp, tp) mesh: port of the JAX
package's parallel/tp.py.

The JAX package runs these bodies under ``shard_map`` with hand-placed
``psum`` after o_proj / down_proj; here every rank runs the same body on its
own shards (SPMD) and the row-parallel sites sum over the rank's tp group
(models/dit.py ``group``).  Each function below is bound to a mesh and takes
this rank's parameter tree (``sharding.shard_params``):

  * :func:`make_tp_dit_forward`: one DiT forward (tp.py:265-286);
  * :func:`make_tp_sampler` / :func:`make_tp_cfg_sampler`: the whole Euler
    loop (the condition projection, the per-layer cross K/V of the local heads
    and every DiT step), the batch split over dp where ``batch_sharded``
    (each dp row block on its own dp rank, the latents gathered back in dp
    order), else replicated on every rank (tp.py:89-199);
  * :func:`make_tp_condition`: lyric and timbre encoders tensor-parallel, the
    Qwen text encoder replicated on every rank (tp.py:202-262);
  * :func:`make_tp_train_step`: the full fine-tune step of
    ``training.flow_matching`` on the rank's shards and dp rows (the JAX
    package jits ``make_train_step`` on sharded arrays,
    tests/test_sharding.py:92-121).

SDE draws: the caller passes them (``sde_noise``, global rows; each dp rank
takes its own) or a generator.  Under a dp split the engine seeds each dp
rank's generator apart (the JAX ``fold_in`` of the dp index, tp.py:132), so
draws are equal across the tp ranks of a dp row and distinct across dp rows.
"""

from __future__ import annotations

import dataclasses

import torch

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.parallel.distributed import all_gather_cat
from acestep_tpu_torch.parallel.mesh import Mesh
from acestep_tpu_torch.parallel.sharding import cut_specs, shard_batch

_COVER_KEYS = ("encoder_hidden_states_non_cover", "context_latents_non_cover",
               "encoder_attn_mask_non_cover")


def local_cfg(cfg, tp: int):
    """Per-shard config: each TP rank owns nh/tp query heads and nkv/tp KV
    heads (a DiT or a Qwen config)."""
    if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp:
        raise ValueError(f"tp={tp} must divide heads "
                         f"({cfg.num_attention_heads}/{cfg.num_key_value_heads})")
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // tp,
                               num_key_value_heads=cfg.num_key_value_heads // tp)


def _split(mesh: Mesh, batch_sharded: bool, *xs, dim: int = 0):
    return tuple(shard_batch(x, mesh, dim) if batch_sharded else x for x in xs)


def _gather(mesh: Mesh, batch_sharded: bool, x: torch.Tensor) -> torch.Tensor:
    return all_gather_cat(x, mesh.dp_group, dim=0) if batch_sharded else x


def make_tp_dit_forward(cfg: DiTConfig, mesh: Mesh):
    """fn(params, hidden_states, timestep, encoder_hidden_states,
    context_latents) -> velocity, the whole batch on every rank; ``params``
    is this rank's tree from ``shard_params`` on the same mesh."""
    cfg_l = local_cfg(cfg, mesh.tp)

    @torch.no_grad()
    def run(params, hs, t, enc, ctx, attn_mask=None, encoder_attn_mask=None):
        kv = dit.compute_all_cross_kv(params, cfg_l, dit.compute_condition(params, cfg_l, enc))
        return dit.forward(params, cfg_l, hs, t, t, ctx, kv, attn_mask=attn_mask,
                           encoder_attn_mask=encoder_attn_mask, group=mesh.tp_group)

    return run


def make_tp_sampler(cfg: DiTConfig, mesh: Mesh):
    """The turbo sampler (``sampler.sample_latents``) over the mesh:
    run(params, noise, ctx, enc, enc_mask, schedule, *, batch_sharded, ...)
    with ``sample_latents``' keywords, the cover switch's included."""
    from acestep_tpu_torch import sampler

    cfg_l = local_cfg(cfg, mesh.tp)

    def run(params, noise, ctx, enc, enc_mask, schedule, *, batch_sharded: bool = False,
            attn_mask=None, sde_noise=None, **kw) -> torch.Tensor:
        noise, ctx, enc, enc_mask, attn_mask = _split(mesh, batch_sharded, noise, ctx, enc,
                                                      enc_mask, attn_mask)
        (sde_noise,) = _split(mesh, batch_sharded, sde_noise, dim=1)
        for k in _COVER_KEYS:
            if kw.get(k) is not None:
                (kw[k],) = _split(mesh, batch_sharded, kw[k])
        out = sampler.sample_latents(params, cfg_l, noise, ctx, enc, enc_mask, schedule,
                                     attn_mask=attn_mask, sde_noise=sde_noise,
                                     group=mesh.tp_group, **kw)
        return _gather(mesh, batch_sharded, out)

    return run


def make_tp_cfg_sampler(cfg: DiTConfig, mesh: Mesh):
    """The base model's CFG sampler (``sampler.sample_latents_cfg``) over the
    mesh: run(params, noise, ctx, enc, enc_mask, enc_u, enc_u_mask, schedule,
    *, batch_sharded, ...) with ``sample_latents_cfg``' keywords."""
    from acestep_tpu_torch import sampler

    cfg_l = local_cfg(cfg, mesh.tp)

    def run(params, noise, ctx, enc, enc_mask, enc_u, enc_u_mask, schedule, *,
            batch_sharded: bool = False, attn_mask=None, sde_noise=None, **kw) -> torch.Tensor:
        noise, ctx, enc, enc_mask, enc_u, enc_u_mask, attn_mask = _split(
            mesh, batch_sharded, noise, ctx, enc, enc_mask, enc_u, enc_u_mask, attn_mask)
        (sde_noise,) = _split(mesh, batch_sharded, sde_noise, dim=1)
        out = sampler.sample_latents_cfg(params, cfg_l, noise, ctx, enc, enc_mask, enc_u,
                                         enc_u_mask, schedule, attn_mask=attn_mask,
                                         sde_noise=sde_noise, group=mesh.tp_group, **kw)
        return _gather(mesh, batch_sharded, out)

    return run


def make_tp_condition(dit_cfg: DiTConfig, text_cfg, mesh: Mesh):
    """run(dit_params, text_params, style_ids, style_mask, lyric_ids,
    lyric_mask, refer_latents, refer_frame_mask, refer_clip_mask) -> (packed
    hidden, packed mask), ``pipeline.encode_condition`` with the lyric and
    timbre encoders tensor-parallel and the text encoder replicated; the whole
    batch on every rank."""
    from acestep_tpu_torch import pipeline

    cfg_l = local_cfg(dit_cfg, mesh.tp)

    def run(dit_params, text_params, *args):
        return pipeline.encode_condition(dit_params, text_params, cfg_l, text_cfg, *args,
                                         group=mesh.tp_group)

    return run



def make_tp_train_step(cfg: DiTConfig, optimizer, mesh: Mesh):
    """``training.flow_matching.make_train_step`` over the mesh:
    step(params, opt_state, batch, t, noise) -> (params, opt_state, loss).

    ``params`` is this rank's shards of an unfused (per-layer list) float DiT
    tree (``sharding.shard_params``) and ``opt_state`` its AdamW state
    (``optimizer.init`` on the same shards).  ``batch``, ``t`` and ``noise``
    are the whole batch's, as ``make_train_step`` takes them; each dp rank
    takes its rows.  The ranks agree as ``flow_matching.GradSync`` says; the
    loss returned is the whole batch's, on every rank.  At one rank this is
    ``make_train_step`` bit for bit."""
    from acestep_tpu_torch.training import flow_matching as fm
    from acestep_tpu_torch.weights import tree_leaves

    cfg_l = local_cfg(cfg, mesh.tp)

    def step(params, opt_state, batch, t, noise):
        for x in tree_leaves(params):
            if not isinstance(x, torch.Tensor):
                raise ValueError("a full fine-tune needs float parameters, got "
                                 f"{type(x).__name__}")
        batch = {k: shard_batch(v, mesh) for k, v in batch.items()}
        t, noise = shard_batch(t, mesh), shard_batch(noise, mesh)
        sync = fm.GradSync(mesh.dp_group, mesh.tp_group, mesh.world,
                           tuple(s != "whole" for s in tree_leaves(cut_specs(params, mesh))))
        return fm.guarded_step(
            lambda p: fm.flow_matching_loss(p, cfg_l, batch, t, noise, group=mesh.tp_group,
                                            dp_group=mesh.dp_group),
            params, opt_state, optimizer, keep_state=True, sync=sync)

    return step
