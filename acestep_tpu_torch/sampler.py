"""Flow-matching Euler sampler (turbo: 8 steps, CFG-free), ODE and SDE forms.

Port of the JAX package's sampler.py schedules and ``sample_latents``.  Noise
comes in as an argument: torch cannot reproduce ``jax.random`` draws, so parity
tests hand both packages the same numpy noise, and the SDE form's per-step
draws likewise (``sde_noise``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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
) -> torch.Tensor:
    """Run the Euler loop; returns clean latents x0 [B, T, 64] (f32).

    The condition is projected and its per-layer cross-attention K/V computed
    once (and stacked once for the megakernel), then the DiT runs once per
    schedule step.  ``dit_mega`` / ``int8_act``: ``dit.forward``'s switches.

    ``infer_method="sde"`` re-noises the x0 prediction every step but the last:
    ``x = t_next * eps + (1 - t_next) * x0``.  The draws ``eps`` are
    ``sde_noise[i]`` ([n_steps, B, T, 64]; the last one is not used) where
    given, else standard normal draws from ``sde_generator``."""
    if infer_method not in INFER_METHODS:
        raise ValueError(f"infer_method={infer_method!r}: expected one of {INFER_METHODS}")
    b = noise.shape[0]
    dtype = torch.bfloat16
    dev = noise.device
    xt = noise.float()
    enc = dit.compute_condition(params, cfg, encoder_hidden_states.to(dtype), int8_act)
    kv = dit.compute_all_cross_kv(params, cfg, enc)
    kv_stacked = dit.stack_cross_kv(kv) if dit_mega and b == 1 and attn_mask is None else None
    ts = torch.tensor(list(schedule) + [0.0], dtype=torch.float32, device=dev)
    n_steps = len(schedule)
    for i in range(n_steps):
        t, t_next = ts[i], ts[i + 1]
        t_b = t.expand(b)
        vt = dit.forward(params, cfg, xt.to(dtype), t_b, t_b, context_latents, kv,
                         attn_mask=attn_mask, encoder_attn_mask=encoder_attn_mask,
                         dit_mega=dit_mega, int8_act=int8_act,
                         cross_kv_stacked=kv_stacked).float()
        if i == n_steps - 1:
            xt = xt - vt * t
        elif infer_method == "sde":
            eps = (sde_noise[i].to(dev, torch.float32) if sde_noise is not None
                   else torch.randn(xt.shape, generator=sde_generator, device=dev))
            xt = t_next * eps + (1.0 - t_next) * (xt - vt * t)
        else:
            xt = xt - vt * (t - t_next)
    return xt
