"""Model/architecture configs (the port's own copy; same fields and defaults as
the JAX package's config module).

Defaults are the turbo DiT (2048 wide x 24 layers), the Qwen3-0.6B text
encoder (1024 wide x 28 layers; also the LM planner's backbone, QWEN3_0_6B)
and the ACE-Step 48 kHz stereo Oobleck VAE (hop 1920 -> 25 Hz latents, latent
dim 64).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _known_fields(cls, d: dict) -> dict:
    """The entries of ``d`` that name a field of ``cls`` (a config file may carry
    more keys)."""
    keys = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in keys}


def _alternating_layer_types(n: int) -> Tuple[str, ...]:
    # odd layers (1-based) sliding, even full
    return tuple(
        "sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(n)
    )


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    in_channels: int = 192                 # context (128) + audio latent (64)
    audio_acoustic_hidden_dim: int = 64
    patch_size: int = 2
    sliding_window: int = 128
    layer_types: Tuple[str, ...] = ()
    rope_theta: float = 1e6
    max_position_embeddings: int = 32768
    text_hidden_dim: int = 1024            # Qwen3-Embedding-0.6B hidden
    num_lyric_encoder_hidden_layers: int = 8
    timbre_hidden_dim: int = 64
    num_timbre_encoder_hidden_layers: int = 4
    timbre_fix_frame: int = 750

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(
                self, "layer_types", _alternating_layer_types(self.num_hidden_layers)
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    @property
    def context_dim(self) -> int:
        return self.in_channels - self.audio_acoustic_hidden_dim

    @classmethod
    def from_dict(cls, d: dict) -> "DiTConfig":
        kw = _known_fields(cls, d)
        if kw.get("layer_types"):
            kw["layer_types"] = tuple(kw["layer_types"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    """Qwen3 transformer (text encoder = Qwen3-Embedding-0.6B)."""

    vocab_size: int = 151669
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    intermediate_size: int = 3072
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tie_word_embeddings: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "QwenConfig":
        return cls(**_known_fields(cls, d))


# the LM planner sizes (Qwen3-0.6B / 1.7B / 4B fine-tunes)
QWEN3_0_6B = QwenConfig(
    hidden_size=1024, num_hidden_layers=28, num_attention_heads=16,
    num_key_value_heads=8, intermediate_size=3072,
)
QWEN3_1_7B = QwenConfig(
    hidden_size=2048, num_hidden_layers=28, num_attention_heads=16,
    num_key_value_heads=8, intermediate_size=6144,
)
QWEN3_4B = QwenConfig(
    hidden_size=2560, num_hidden_layers=36, num_attention_heads=32,
    num_key_value_heads=8, intermediate_size=9728,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Oobleck VAE (diffusers AutoencoderOobleck schema)."""

    audio_channels: int = 2
    encoder_hidden_size: int = 128
    decoder_channels: int = 128
    decoder_input_channels: int = 64       # latent dim
    sampling_rate: int = 48000
    downsampling_ratios: Tuple[int, ...] = (2, 4, 4, 6, 10)   # hop 1920 -> 25 Hz
    channel_multiples: Tuple[int, ...] = (1, 2, 4, 8, 16)

    @property
    def hop_length(self) -> int:
        return math.prod(self.downsampling_ratios)

    @property
    def upsampling_ratios(self) -> Tuple[int, ...]:
        return tuple(reversed(self.downsampling_ratios))

    @classmethod
    def from_dict(cls, d: dict) -> "VAEConfig":
        kw = _known_fields(cls, d)
        for k in ("downsampling_ratios", "channel_multiples"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return cls(**kw)
