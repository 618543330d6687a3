"""Flow-matching Euler samplers, ODE and SDE forms: the turbo loop (8 steps,
CFG-free, with the cover task's condition switch) and the base model's
classifier-free-guided loop (CFG / ADG).

Port of the JAX package's sampler.py schedules, ``sample_latents`` and
``sample_latents_cfg``.  Noise comes in as an argument: torch cannot
reproduce ``jax.random`` draws, so parity tests hand both packages the same
numpy noise, and the SDE form's per-step draws likewise (``sde_noise``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models import dit

VALID_SHIFTS = (1.0, 2.0, 3.0)

VALID_TIMESTEPS = (
    1.0, 0.9545454545454546, 0.9333333333333333, 0.9, 0.875,
    0.8571428571428571, 0.8333333333333334, 0.7692307692307693, 0.75,
    0.6666666666666666, 0.6428571428571429, 0.625, 0.5454545454545454,
    0.5, 0.4, 0.375, 0.3, 0.25, 0.2222222222222222, 0.125,
)

SHIFT_TIMESTEPS = {
    1.0: (1.0, 0.875, 0.75, 0.625, 0.5, 0.375, 0.25, 0.125),
    2.0: (1.0, 0.9333333333333333, 0.8571428571428571, 0.7692307692307693,
          0.6666666666666666, 0.5454545454545454, 0.4, 0.2222222222222222),
    3.0: (1.0, 0.9545454545454546, 0.9, 0.8333333333333334, 0.75,
          0.6428571428571429, 0.5, 0.3),
}

MAX_CUSTOM_TIMESTEPS = 20
INFER_METHODS = ("ode", "sde")


def get_timestep_schedule(shift: float = 3.0,
                          timesteps: Optional[Sequence[float]] = None) -> Tuple[float, ...]:
    """Resolve the step schedule; custom lists snap to the 20-value whitelist."""
    if timesteps is not None:
        ts = [float(t) for t in timesteps]
        while ts and ts[-1] == 0:
            ts.pop()
        if ts:
            ts = ts[:MAX_CUSTOM_TIMESTEPS]
            return tuple(min(VALID_TIMESTEPS, key=lambda x, t=t: abs(x - t)) for t in ts)
    shift = min(VALID_SHIFTS, key=lambda x: abs(x - shift))
    return SHIFT_TIMESTEPS[shift]


def get_base_timestep_schedule(num_steps: int, shift: float = 1.0) -> Tuple[float, ...]:
    """The base model's schedule: ``num_steps`` descending timesteps warped by
    ``shift * t / (1 + (shift - 1) * t)`` (sampler.py:59-68)."""
    ts = np.linspace(1.0, 1.0 / num_steps, num_steps)
    shifted = shift * ts / (1.0 + (shift - 1.0) * ts)
    return tuple(float(t) for t in shifted)


def _check_method(infer_method: str) -> None:
    if infer_method not in INFER_METHODS:
        raise ValueError(f"infer_method={infer_method!r}: expected one of {INFER_METHODS}")


def _euler(xt, vt, t, t_next, last: bool, infer_method: str, eps_fn):
    """One step: x0 at the last, else the ODE step or the SDE re-noise
    ``t_next * eps + (1 - t_next) * x0``."""
    if last:
        return xt - vt * t
    if infer_method == "sde":
        return t_next * eps_fn() + (1.0 - t_next) * (xt - vt * t)
    return xt - vt * (t - t_next)


def _sde_draw(i, shape, dev, sde_noise, sde_generator):
    return (sde_noise[i].to(dev, torch.float32) if sde_noise is not None
            else torch.randn(shape, generator=sde_generator, device=dev))


@torch.no_grad()
def sample_latents(
    params: Dict[str, Any],
    cfg: DiTConfig,
    noise: torch.Tensor,                    # [B, T, 64]
    context_latents: torch.Tensor,          # [B, T, ctx_dim]
    encoder_hidden_states: torch.Tensor,    # [B, Lc, H]
    encoder_attn_mask: Optional[torch.Tensor],
    schedule: Tuple[float, ...],
    *,
    attn_mask: Optional[torch.Tensor] = None,
    dit_mega: bool = False,
    int8_act: bool = False,
    infer_method: str = "ode",
    sde_noise: Optional[torch.Tensor] = None,
    sde_generator: Optional[torch.Generator] = None,
    cover_steps: int = 0,
    encoder_hidden_states_non_cover: Optional[torch.Tensor] = None,
    context_latents_non_cover: Optional[torch.Tensor] = None,
    encoder_attn_mask_non_cover: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the Euler loop; returns clean latents x0 [B, T, 64] (f32).

    The condition is projected and its per-layer cross-attention K/V computed
    once (and stacked once for the megakernel), then the DiT runs once per
    schedule step.  ``dit_mega`` / ``int8_act``: ``dit.forward``'s switches.

    The cover switch (sampler.py:100-193): with
    ``encoder_hidden_states_non_cover`` given, both conditions' K/V are
    computed once, and from step ``cover_steps`` on the non-cover K/V,
    context and condition mask replace the cover ones.  The megakernel path
    takes the same switch (both K/V stacks, the step's chosen per step).

    ``infer_method="sde"`` re-noises the x0 prediction every step but the last:
    ``x = t_next * eps + (1 - t_next) * x0``.  The draws ``eps`` are
    ``sde_noise[i]`` ([n_steps, B, T, 64]; the last one is not used) where
    given, else standard normal draws from ``sde_generator``."""
    _check_method(infer_method)
    b = noise.shape[0]
    dtype = torch.bfloat16
    dev = noise.device
    xt = noise.float()
    mega = dit_mega and b == 1 and attn_mask is None

    def condition(hidden):
        kv = dit.compute_all_cross_kv(
            params, cfg, dit.compute_condition(params, cfg, hidden.to(dtype), int8_act))
        return kv, (dit.stack_cross_kv(kv) if mega else None)

    kv, kv_stacked = condition(encoder_hidden_states)
    switch = encoder_hidden_states_non_cover is not None
    if switch:
        kv_nc, kv_nc_stacked = condition(encoder_hidden_states_non_cover)
    ts = torch.tensor(list(schedule) + [0.0], dtype=torch.float32, device=dev)
    n_steps = len(schedule)
    for i in range(n_steps):
        t, t_next = ts[i], ts[i + 1]
        t_b = t.expand(b)
        kv_i, st_i, ctx_i, mask_i = kv, kv_stacked, context_latents, encoder_attn_mask
        if switch and i >= cover_steps:
            kv_i, st_i, ctx_i = kv_nc, kv_nc_stacked, context_latents_non_cover
            if encoder_attn_mask is not None and encoder_attn_mask_non_cover is not None:
                mask_i = encoder_attn_mask_non_cover
        vt = dit.forward(params, cfg, xt.to(dtype), t_b, t_b, ctx_i, kv_i,
                         attn_mask=attn_mask, encoder_attn_mask=mask_i,
                         dit_mega=dit_mega, int8_act=int8_act,
                         cross_kv_stacked=st_i).float()
        xt = _euler(xt, vt, t, t_next, i == n_steps - 1, infer_method,
                    lambda: _sde_draw(i, xt.shape, dev, sde_noise, sde_generator))
    return xt


def _pad_condition(h: torch.Tensor, m: Optional[torch.Tensor], length: int):
    """A condition [B, L, H] and its mask (ones where None) zero-padded to
    ``length`` tokens."""
    if m is None:
        m = torch.ones(h.shape[:2], dtype=torch.int32, device=h.device)
    pad = length - h.shape[1]
    return (torch.nn.functional.pad(h, (0, 0, 0, pad)),
            torch.nn.functional.pad(m.to(torch.int32), (0, pad)))


@torch.no_grad()
def sample_latents_cfg(
    params: Dict[str, Any],
    cfg: DiTConfig,
    noise: torch.Tensor,                    # [B, T, 64]
    context_latents: torch.Tensor,          # [B, T, ctx_dim]
    encoder_hidden_states: torch.Tensor,    # [B, Lc, H] cond
    encoder_attn_mask: Optional[torch.Tensor],
    uncond_hidden_states: torch.Tensor,     # [B, Lu, H] uncond
    uncond_attn_mask: Optional[torch.Tensor],
    schedule: Tuple[float, ...],
    *,
    guidance_scale: float = 7.0,
    cfg_interval_start: float = 0.0,
    cfg_interval_end: float = 1.0,
    use_adg: bool = False,
    infer_method: str = "ode",
    sde_noise: Optional[torch.Tensor] = None,
    sde_generator: Optional[torch.Generator] = None,
    attn_mask: Optional[torch.Tensor] = None,
    int8_act: bool = False,
) -> torch.Tensor:
    """The base model's classifier-free-guided Euler loop (sampler.py:321-425).

    Cond and uncond are padded to a common length and run as one 2B forward a
    step (the layer path: the megakernel takes batch 1 only); inside the
    interval ``cfg_interval_start <= 1 - t <= cfg_interval_end`` the velocity
    is ``v_u + guidance_scale * (v_c - v_u)``, outside it ``v_c``.  ``use_adg``
    rescales the delta per item to ``|v_c| / max(|delta|, 1e-6)``.  SDE draws as
    :func:`sample_latents`."""
    _check_method(infer_method)
    b = noise.shape[0]
    dtype = torch.bfloat16
    dev = noise.device
    xt = noise.float()
    lc = max(encoder_hidden_states.shape[1], uncond_hidden_states.shape[1])
    enc_c, mask_c = _pad_condition(encoder_hidden_states, encoder_attn_mask, lc)
    enc_u, mask_u = _pad_condition(uncond_hidden_states, uncond_attn_mask, lc)
    enc2 = torch.cat([enc_c.to(dtype), enc_u.to(dtype)], dim=0)          # [2B, L, H]
    mask2 = torch.cat([mask_c, mask_u], dim=0)
    kv2 = dit.compute_all_cross_kv(params, cfg,
                                   dit.compute_condition(params, cfg, enc2, int8_act))
    ctx2 = torch.cat([context_latents, context_latents], dim=0)
    attn2 = None if attn_mask is None else torch.cat([attn_mask, attn_mask], dim=0)
    ts = torch.tensor(list(schedule) + [0.0], dtype=torch.float32, device=dev)
    n_steps = len(schedule)
    lo, hi = np.float32(cfg_interval_start), np.float32(cfg_interval_end)
    for i in range(n_steps):
        t, t_next = ts[i], ts[i + 1]
        t2b = t.expand(2 * b)
        vt2 = dit.forward(params, cfg, torch.cat([xt, xt], dim=0).to(dtype), t2b, t2b, ctx2,
                          kv2, attn_mask=attn2, encoder_attn_mask=mask2,
                          int8_act=int8_act).float()
        v_c, v_u = vt2[:b], vt2[b:]
        # the interval gate on progress = 1 - t, in f32 as the JAX scan compares it
        progress = np.float32(1.0) - np.float32(schedule[i])
        if lo <= progress <= hi:
            delta = v_c - v_u
            if use_adg:
                nc = torch.sqrt(torch.sum(v_c * v_c, dim=(1, 2), keepdim=True))
                nd = torch.sqrt(torch.sum(delta * delta, dim=(1, 2), keepdim=True))
                delta = delta * (nc / torch.clamp(nd, min=1e-6))
            vt = v_u + guidance_scale * delta
        else:
            vt = v_c
        xt = _euler(xt, vt, t, t_next, i == n_steps - 1, infer_method,
                    lambda: _sde_draw(i, xt.shape, dev, sde_noise, sde_generator))
    return xt
