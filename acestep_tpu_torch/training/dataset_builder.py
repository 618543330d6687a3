"""Dataset building: for now only ``audio_to_codes``, which
``inference.understand_audio`` uses (port of the JAX package's
training/dataset_builder.py:133-151)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from acestep_tpu_torch.lm_pipeline import indices_to_codes
from acestep_tpu_torch.models import codec, vae


def audio_to_codes(engine, codec_params: Dict[str, Any], audio: np.ndarray) -> str:
    """Waveform [L, C] -> the 5 Hz audio-code string: the whole latent frames
    VAE-encoded in 128-frame windows of 32 overlap on the engine's device, then
    the codec's ``tokenize``."""
    hop = engine.vae_cfg.hop_length
    t_frames = max(1, audio.shape[0] // hop)
    x = torch.from_numpy(np.ascontiguousarray(audio[None, :t_frames * hop], np.float32))
    lat = vae.tiled_encode(engine.vae_params, engine.vae_cfg, x.to(engine.device),
                           chunk_frames=128, overlap_frames=32)
    idx = codec.tokenize(codec_params, lat)
    return indices_to_codes(idx[0].cpu().tolist())
