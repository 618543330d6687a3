"""Training datasets: preprocess raw songs once into per-sample tensors, then
stream padded batches.  Port of the JAX package's training/data.py.

A dataset directory holds ``sample_XXXXX.safetensors`` (``latents``
[T, 64], ``context_latents`` [T, 128], ``encoder_hidden_states`` [Lc, H],
``encoder_attn_mask`` [Lc] int32, ``loss_mask`` [T], all f32 but the mask)
and ``manifest.json`` (``{"samples": [...], "count": n}``): the JAX package's
layout, so either package reads the other's directory.  The shuffle is numpy's
``default_rng(seed).permutation`` per epoch, so the batch order is the JAX
package's too.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from acestep_tpu_torch.models import vae
from acestep_tpu_torch.pipeline import GenerationRequest
from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile, save_safetensors

SAMPLE_KEYS = ("latents", "context_latents", "encoder_hidden_states", "loss_mask")


@torch.no_grad()
def preprocess_sample(engine, audio: np.ndarray, style_token_ids: np.ndarray,
                      lyric_token_ids: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One training sample from a waveform [L, C] f32 and its tokens: the
    whole latent frames VAE-encoded in 128-frame windows of 32 overlap, the
    packed condition and the text2music context, on the engine's device."""
    hop = engine.vae_cfg.hop_length
    t_frames = audio.shape[0] // hop
    x = torch.from_numpy(np.ascontiguousarray(audio[None, :t_frames * hop], np.float32))
    lat = vae.tiled_encode(engine.vae_params, engine.vae_cfg, x.to(engine.device),
                           chunk_frames=128, overlap_frames=32)
    req = GenerationRequest(style_token_ids=style_token_ids, lyric_token_ids=lyric_token_ids)
    enc, enc_mask = engine.build_condition(req, 1)
    ctx = engine.build_context_latents(req, 1, t_frames, t_frames)
    return {
        "latents": lat[0].float().cpu().numpy(),
        "context_latents": ctx[0].float().cpu().numpy(),
        "encoder_hidden_states": enc[0].float().cpu().numpy(),
        "encoder_attn_mask": enc_mask[0].to(torch.int32).cpu().numpy(),
        "loss_mask": np.ones((t_frames,), np.float32),
    }


def build_dataset(engine, samples: Sequence[Dict[str, Any]], out_dir: str) -> str:
    """Preprocess ``samples`` (``{audio, style_token_ids, lyric_token_ids?}``)
    into ``out_dir``; returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    names = []
    for i, s in enumerate(samples):
        tensors = preprocess_sample(engine, s["audio"], s["style_token_ids"],
                                    s.get("lyric_token_ids"))
        name = f"sample_{i:05d}.safetensors"
        save_safetensors(os.path.join(out_dir, name), tensors)
        names.append(name)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"samples": names, "count": len(names)}, f)
    return out_dir


def _pad(x: np.ndarray, target: int) -> np.ndarray:
    width = [(0, 0)] * x.ndim
    width[0] = (0, target - x.shape[0])
    return np.pad(x, width)


class PreprocessedDataset:
    """Streams a dataset directory as shuffled, zero-padded batches of tensors
    on ``device``."""

    def __init__(self, path: str, device="cpu"):
        self.path = path
        self.device = torch.device(device)
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.names: List[str] = self.manifest["samples"]

    def __len__(self) -> int:
        return len(self.names)

    def load(self, i: int) -> Dict[str, np.ndarray]:
        st = SafetensorsFile(os.path.join(self.path, self.names[i]))
        return {k: np.array(st.tensor(k)) for k in st.keys()}

    def batches(self, batch_size: int, seed: int = 0,
                epochs: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches of ``batch_size`` in ``default_rng(seed)``'s order, cycling
        for ``epochs`` (None = forever)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.names))
            for i0 in range(0, len(order), batch_size):
                items = [self.load(int(i)) for i in order[i0:i0 + batch_size]]
                t_max = max(it["latents"].shape[0] for it in items)
                lc_max = max(it["encoder_hidden_states"].shape[0] for it in items)

                def masks(it):
                    m = it.get("encoder_attn_mask")
                    if m is None:
                        m = np.ones(it["encoder_hidden_states"].shape[0], np.int32)
                    return _pad(m, lc_max)

                batch = {
                    "latents": np.stack([_pad(it["latents"], t_max) for it in items]),
                    "context_latents": np.stack(
                        [_pad(it["context_latents"], t_max) for it in items]),
                    "encoder_hidden_states": np.stack(
                        [_pad(it["encoder_hidden_states"], lc_max) for it in items]),
                    "encoder_attn_mask": np.stack([masks(it) for it in items]),
                    "loss_mask": np.stack([_pad(it["loss_mask"], t_max) for it in items]),
                }
                yield {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            epoch += 1
