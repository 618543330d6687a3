from .blocked_attention import banded_attention, flash_attention, use_blocked_attention
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
    "banded_attention",
    "flash_attention",
    "linear",
    "make_attention_mask",
    "rms_norm",
    "rope_cos_sin",
    "rotate_half",
    "silu",
    "sinusoidal_timestep_embedding",
    "use_blocked_attention",
]
