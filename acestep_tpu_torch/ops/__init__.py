from .blocked_attention import self_attention_masks
from .nn import (
    apply_rope,
    attention,
    make_attention_mask,
    rms_norm,
    rope_cos_sin,
    rotate_half,
    silu,
    sinusoidal_timestep_embedding,
)
from .qlinear import StackedWeight, linear

__all__ = [
    "StackedWeight",
    "apply_rope",
    "attention",
    "linear",
    "make_attention_mask",
    "rms_norm",
    "rope_cos_sin",
    "rotate_half",
    "self_attention_masks",
    "silu",
    "sinusoidal_timestep_embedding",
]
