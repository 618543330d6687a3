"""Flow-matching training of the DiT: the loss, the optimizer and the full
fine-tune step.  Port of the JAX package's training/flow_matching.py.

  * a discrete timestep per example from the turbo shift schedule;
  * x_t = t * noise + (1 - t) * x0, rounded to bf16: the DiT computes in bf16
    whatever the params' dtype (``linear`` casts a float weight to x's dtype);
  * the DiT predicts the velocity; the target is noise - x0;
  * MSE over the loss mask (1 = generated frame).

``t`` and ``noise`` are arguments of the loss and of every step:
``jax.random`` cannot be reproduced, so parity tests pass the JAX draws and
the trainer draws them with a ``torch.Generator`` (:func:`draw`).

The JAX ``dit.forward`` given raw ``encoder_hidden_states`` projects the
condition and computes every layer's cross-attention K/V inside the graph;
the port's ``forward`` takes that cache as an argument, so the loss builds it
(under grad), and ``condition_embedder`` and the cross-attention ``k_proj`` /
``v_proj`` get their gradients.

:func:`make_optimizer` is the port's copy of
``optax.chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))``,
with optax's arithmetic: the schedule is read at the count before the update
(the first step's learning rate is ``schedule(0) = 0``), the bias correction
at ``count + 1``, the cosine's ``decay_steps`` counts the warmup, the clip is
``g / norm * max_norm`` when ``norm >= max_norm``, weight decay is added to
the Adam update before the ``-lr`` scale, ``eps`` is added outside the
square root, and the moments take the params' dtype.  Scalars are rounded to
each leaf's dtype before they meet it, as JAX's weak types are.  Leaves are
updated with ``torch._foreach_*`` in groups of one dtype and device.

Over a (dp, tp) mesh (parallel/tp.make_tp_train_step) every rank runs the
same step on its shards and its dp rows, and :class:`GradSync` says how the
ranks agree: the masked loss divides by the mask count of the whole batch
(summed over dp), the gradients are summed over dp in rank order, the global
norm sums the tp-sharded leaves' squares over tp and counts every replicated
leaf once, and the NaN guard's flag is agreed over the whole world before any
rank branches on it.  A mesh of one rank is the one-process step, bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.parallel.distributed import all_reduce
from acestep_tpu_torch.parallel.mesh import Group
from acestep_tpu_torch.sampler import SHIFT_TIMESTEPS
from acestep_tpu_torch.weights import tree_leaves, tree_map, tree_unflatten

# the top-level parameter groups the loss reads (the condition encoders run
# once per sample when the dataset is built, not in the step)
LOSS_KEYS = ("proj_in", "time_embed", "time_embed_r", "condition_embedder", "layers",
             "norm_out", "out_scale_shift_table", "proj_out")
CHUNK = 64      # leaves updated together (bounds the optimizer's scratch memory)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def sample_discrete_timesteps(generator: torch.Generator, batch: int,
                              shift: float = 3.0) -> torch.Tensor:
    """[batch] timesteps drawn uniformly from the turbo schedule, on the
    generator's device."""
    schedule = torch.tensor(SHIFT_TIMESTEPS[shift], dtype=torch.float32,
                            device=generator.device)
    idx = torch.randint(0, schedule.shape[0], (batch,), generator=generator,
                        device=generator.device)
    return schedule[idx]


def draw(generator: torch.Generator, latents: torch.Tensor,
         shift: float = 3.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B], noise like ``latents``, f32) from ``generator``."""
    t = sample_discrete_timesteps(generator, latents.shape[0], shift)
    noise = torch.randn(latents.shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    return t, noise


def _single(group: Optional[Group]) -> bool:
    return group is None or group.size == 1


def flow_matching_loss(params: Dict[str, Any], cfg: DiTConfig, batch: Dict[str, torch.Tensor],
                       t: torch.Tensor, noise: torch.Tensor, *, group: Optional[Group] = None,
                       dp_group: Optional[Group] = None) -> torch.Tensor:
    """batch: latents [B, T, 64] (x0), context_latents [B, T, ctx],
    encoder_hidden_states [B, Lc, H], encoder_attn_mask [B, Lc] (optional),
    loss_mask [B, T] (optional; 1 = generated frame).  ``t`` [B] and ``noise``
    [B, T, 64] are the draws.  Returns the scalar f32 loss.

    ``group``: the tp group (params and ``cfg`` this rank's shards and local
    heads).  ``dp_group``: the batch is this dp rank's rows, and the loss is
    its share of the whole batch's: its numerator over the count of the whole
    batch, so that the shares sum to the one-process loss (a mean of the dp
    ranks' own means is another number whenever their masks differ)."""
    x0 = batch["latents"].float()
    t_b = t.float()[:, None, None]
    xt = t_b * noise.float() + (1.0 - t_b) * x0
    target = noise.float() - x0
    xt = xt.to(torch.bfloat16)
    enc = dit.compute_condition(params, cfg, batch["encoder_hidden_states"].to(xt.dtype))
    kv = dit.compute_all_cross_kv(params, cfg, enc, group)
    v = dit.forward(params, cfg, xt, t, t, batch["context_latents"], kv,
                    encoder_attn_mask=batch.get("encoder_attn_mask"), group=group).float()
    err = torch.square(v - target)
    mask = batch.get("loss_mask")
    if _single(dp_group):
        if mask is not None:
            m = mask.float()[:, :, None]
            return torch.sum(err * m) / torch.clamp(torch.sum(m) * x0.shape[-1], min=1.0)
        return torch.mean(err)
    if mask is not None:
        m = mask.float()[:, :, None]
        count = all_reduce(torch.sum(m), dp_group) * x0.shape[-1]
        return torch.sum(err * m) / torch.clamp(count, min=1.0)
    count = all_reduce(torch.tensor(float(err.numel()), device=err.device), dp_group)
    return torch.sum(err) / count


def loss_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The groups of ``params`` the loss reads (:data:`LOSS_KEYS`)."""
    return {k: v for k, v in params.items() if k in LOSS_KEYS}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a Python float the foreach ops take exactly)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass
class AdamWState:
    """optax's chain state: ``count`` updates applied (the Adam count and the
    schedule's count, which move together), the moments as trees shaped like
    the params (in their dtypes)."""

    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``clip_by_global_norm(clip_norm)`` then ``adamw(schedule, b1, b2, eps,
    weight_decay)`` with the warmup-cosine schedule (init 0, end
    ``end_value``)."""

    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    end_value: float = 0.0

    def __post_init__(self):
        if self.total_steps - self.warmup_steps <= 0:
            raise ValueError("the cosine decay needs total_steps > warmup_steps, got "
                             f"{self.total_steps} and {self.warmup_steps}")

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, end_value)
        at ``count``, in f32 as optax computes it (at ``end_value`` 0 the
        decay is the cosine itself: ``1 * cosine + 0`` is exact)."""
        f = np.float32
        w = self.warmup_steps
        if count < w:       # join_schedules: the linear warmup before the boundary
            c = min(max(count, 0), w)
            frac = f(1) - f(c) / f(w)
            return _f32(f(0.0 - self.lr) * frac + f(self.lr))
        decay = f(self.total_steps - w)
        c = min(f(count - w), decay)
        cosine = f(0.5) * (f(1) + f(np.cos(f(np.pi) * c / decay)))
        alpha = 0.0 if self.lr == 0.0 else self.end_value / self.lr
        return _f32(f(self.lr) * (f(1 - alpha) * cosine + f(alpha)))

    def init(self, params) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def global_norm(self, grads: List[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                    group: Optional[Group] = None) -> torch.Tensor:
        """sqrt of the sum of squares over every leaf (f32, on the device).
        Under tensor parallelism (``group``) the squares of the leaves that
        ``sharded`` marks (this rank holds a cut of them) are summed over the
        group, and every other leaf, replicated on each rank, counts once."""
        sums = [torch.sum(torch.square(g.float())) for g in grads]
        if _single(group):
            return torch.sqrt(torch.stack(sums).sum())
        cut = [x for x, c in zip(sums, sharded) if c]
        whole = [x for x, c in zip(sums, sharded) if not c]
        total = all_reduce(torch.stack(cut).sum(), group) if cut else sums[0].new_zeros(())
        if whole:
            total = total + torch.stack(whole).sum()
        return torch.sqrt(total)

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: AdamWState, norm: float) -> Tuple[List[torch.Tensor], AdamWState]:
        """One update of the leaves ``params`` by ``grads`` (whose global norm
        ``norm`` the caller read): (new leaves, new state).  The old tensors are
        left as they were."""
        clip = norm >= self.clip_norm
        count = state.count + 1
        lr = -self.schedule(state.count)
        bc1 = _f32(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        out_p, out_mu, out_nu = [None] * len(params), [None] * len(params), [None] * len(params)
        groups: Dict[Tuple, List[int]] = {}
        for i, p in enumerate(params):
            groups.setdefault((p.device, p.dtype), []).append(i)
        for (_, dtype), idx in groups.items():
            def s(x, dtype=dtype):
                return _scalar(x, dtype)

            for c0 in range(0, len(idx), CHUNK):
                ii = idx[c0:c0 + CHUNK]
                p = [params[i] for i in ii]
                g = [grads[i].to(dtype) for i in ii]
                if clip:
                    g = torch._foreach_div(g, s(norm))
                    torch._foreach_mul_(g, s(self.clip_norm))
                m = torch._foreach_mul(g, s(1 - self.b1))
                torch._foreach_add_(m, torch._foreach_mul([mu[i] for i in ii], s(self.b1)))
                v = torch._foreach_mul(torch._foreach_mul(g, g), s(1 - self.b2))
                torch._foreach_add_(v, torch._foreach_mul([nu[i] for i in ii], s(self.b2)))
                del g
                u = torch._foreach_div(m, s(bc1))
                den = torch._foreach_div(v, s(bc2))
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, s(self.eps))
                torch._foreach_div_(u, den)
                del den
                torch._foreach_add_(u, torch._foreach_mul(p, s(self.weight_decay)))
                torch._foreach_mul_(u, s(lr))
                new = torch._foreach_add(p, u)
                for j, i in enumerate(ii):
                    out_p[i], out_mu[i], out_nu[i] = new[j], m[j], v[j]
        return out_p, AdamWState(count, tree_unflatten(state.mu, out_mu),
                                 tree_unflatten(state.nu, out_nu))


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01, warmup_steps: int = 100,
                   total_steps: int = 10000, clip_norm: float = 1.0) -> AdamW:
    """AdamW with warmup -> cosine and a global-norm clip."""
    return AdamW(lr=lr, weight_decay=weight_decay, warmup_steps=warmup_steps,
                 total_steps=total_steps, clip_norm=clip_norm)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradSync:
    """How the ranks of a (dp, tp) mesh agree on a step (module docstring):
    ``dp`` sums the loss shares and the gradients, ``tp`` the squares of the
    ``sharded`` leaves (one flag per leaf of the trainable tree), ``world``
    the NaN guard's flag."""

    dp: Optional[Group]
    tp: Optional[Group]
    world: Optional[Group]
    sharded: Tuple[bool, ...]


def sum_over(grads: List[torch.Tensor], group: Optional[Group]) -> List[torch.Tensor]:
    """Each gradient summed over ``group`` in rank order (``all_reduce``'s
    f32 sum, rounded once), one exchange per dtype and device."""
    if _single(group):
        return grads
    out = list(grads)
    by: Dict[Tuple, List[int]] = {}
    for i, g in enumerate(grads):
        by.setdefault((g.device, g.dtype), []).append(i)
    for idx in by.values():
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), group)
        for i, part in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
            out[i] = part.view(grads[i].shape)
    return out


def guarded_step(loss_of: Callable[[Any], torch.Tensor], trainable, opt_state: AdamWState,
                 optimizer: AdamW, keep_state: bool, sync: Optional[GradSync] = None):
    """loss -> grads -> NaN guard -> clip -> AdamW over ``trainable``'s leaves:
    (new trainable, new state, loss).  A leaf the loss does not reach gets a
    zero gradient (weight decay still moves it, as in optax).  On a non-finite
    gradient the trainable tree is kept; ``keep_state`` keeps the optimizer
    state too (the full step), else the update runs on zeroed gradients and
    only its state is kept (the adapter steps).  ``sync``: the mesh's
    agreement (:class:`GradSync`); the loss returned is then the whole
    batch's.  The host reads the device once."""
    leaves = [x.detach() for x in tree_leaves(trainable)]
    live = [x.detach().requires_grad_() for x in leaves]
    loss = loss_of(tree_unflatten(trainable, live))
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    loss = loss.detach()
    if sync is not None:
        grads, loss = sum_over(grads, sync.dp), all_reduce(loss, sync.dp)
    bad = (~torch.stack([torch.isfinite(g).all() for g in grads]).all()).float()
    if sync is not None:
        # agreed before anyone branches: a rank that updates while another
        # keeps its state would mix shards of two steps in the next collective
        bad = all_reduce(bad, sync.world)
        norm = optimizer.global_norm(grads, sync.sharded, sync.tp)
    else:
        norm = optimizer.global_norm(grads)
    bad, norm = torch.stack([bad, norm]).tolist()
    finite = bad == 0
    if not finite:
        if keep_state:
            return trainable, opt_state, loss
        grads = [torch.zeros_like(g) for g in grads]
        norm = 0.0
    new, state = optimizer.apply(leaves, grads, opt_state, norm)
    if not finite:
        return trainable, state, loss
    return tree_unflatten(trainable, new), state, loss


def make_train_step(cfg: DiTConfig, optimizer: AdamW):
    """The full fine-tune step ``step(params, opt_state, batch, t, noise) ->
    (params, opt_state, loss)``; a non-finite gradient keeps the params and the
    optimizer state, count included.  The draws come in (:func:`draw` makes
    them at the schedule's shift)."""

    def step(params, opt_state, batch, t, noise):
        for x in tree_leaves(params):
            if not isinstance(x, torch.Tensor):
                raise ValueError("a full fine-tune needs float parameters, got "
                                 f"{type(x).__name__}")
        return guarded_step(lambda p: flow_matching_loss(p, cfg, batch, t, noise),
                            params, opt_state, optimizer, keep_state=True)

    return step
