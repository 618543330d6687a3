"""End-to-end text2music pipeline on the card: port of the JAX package's
pipeline.py main path.

Flow:
  style tokens -> Qwen3 text encoder -> text_projector       \\
  lyric tokens -> Qwen embeddings -> DiT lyric encoder        > pack [lyric | style]
  context_latents = concat(silence src latents, chunk mask)
  8-step flow-matching Euler loop (DiT)
  tiled VAE decode -> int16 waveform at the global peak scale

Latent lengths are bucketed (frames rounded up to FRAME_BUCKET); validity is
carried by the attention mask and trailing frames are sliced off before the
decode.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for the card where there is none raises.

``AceStepEngine(dit_mega=True)`` and ``(int8_act=True)`` stand for the JAX
package's ``ACESTEP_TPU_DIT_MEGA=1`` and ``ACESTEP_TPU_INT8_ACT=1`` (see
models/dit.py).  The megakernel runs only where no self-attention mask is
needed, i.e. where the frames fill their bucket exactly: at full width
10.24 s (256 frames, 128 patch tokens) is such a request.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch import sampler
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.constants import (
    FRAME_BUCKET, LATENT_RATE, MAX_DURATION_S, MIN_DURATION_S, TOKEN_BUCKETS,
)
from acestep_tpu_torch.models import dit, qwen, vae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.qlinear import precast_quant_scales

VAE_CHUNK_FRAMES = 512      # decode window (the JAX planner's choice on a large card)
VAE_WINDOW_BATCH = 4


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the host")
    return dev


def frames_for_duration(seconds: float) -> int:
    seconds = min(max(seconds, MIN_DURATION_S), MAX_DURATION_S)
    return int(round(seconds * LATENT_RATE))


def bucket_frames(frames: int) -> int:
    return int(math.ceil(frames / FRAME_BUCKET) * FRAME_BUCKET)


def pack_sequences(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Concatenate (hidden [B, L_i, H], mask [B, L_i]) parts along L, then
    stable-partition each row so valid tokens come first."""
    hidden = torch.cat([h for h, _ in parts], dim=1)
    mask = torch.cat([m for _, m in parts], dim=1)
    order = torch.argsort((mask == 0).to(torch.int32), dim=1, stable=True)
    packed_h = torch.gather(hidden, 1, order[:, :, None].expand(-1, -1, hidden.shape[2]))
    return packed_h, torch.gather(mask, 1, order)


def _token_bucket(n: int) -> int:
    for b in TOKEN_BUCKETS:
        if n <= b:
            return b
    return TOKEN_BUCKETS[-1]


def _pad_tokens(ids, mask, device):
    ids = np.asarray(ids, np.int64)
    mask = np.ones_like(ids) if mask is None else np.asarray(mask, np.int64)
    b = _token_bucket(ids.shape[1])
    pad = b - ids.shape[1]
    if pad > 0:
        ids = np.pad(ids, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    return (torch.from_numpy(ids[:, :b]).to(device),
            torch.from_numpy(mask[:, :b].astype(np.int32)).to(device))


@torch.no_grad()
def encode_condition(dit_params, text_params, dit_cfg: DiTConfig, text_cfg: QwenConfig,
                     style_ids, style_mask, lyric_ids, lyric_mask):
    """Lyric + style condition -> (packed_hidden [B, Ll+Ls, H], packed_mask)."""
    parts = []
    if lyric_ids is not None:
        emb = qwen.embeddings_only(text_params, lyric_ids)
        parts.append((dit.lyric_encoder(dit_params, dit_cfg, emb, lyric_mask), lyric_mask))
    if style_ids is not None:
        hs = qwen.forward(text_params, text_cfg, style_ids, style_mask)
        parts.append((dit.text_projector(dit_params, hs), style_mask))
    if not parts:
        raise ValueError("empty condition: need style or lyric input")
    return pack_sequences(parts)


@dataclasses.dataclass
class GenerationRequest:
    """One text2music request, pre-tokenized."""

    duration_s: float = 30.0
    style_token_ids: Optional[np.ndarray] = None      # [B, Ls]
    style_mask: Optional[np.ndarray] = None
    lyric_token_ids: Optional[np.ndarray] = None      # [B, Ll]
    lyric_mask: Optional[np.ndarray] = None
    task: str = "text2music"
    seeds: Optional[Sequence[int]] = None
    shift: float = 3.0
    timesteps: Optional[Sequence[float]] = None
    batch_size: int = 1


@dataclasses.dataclass
class GenerationResult:
    """16-bit PCM ``audio_i16 [B, L, C]`` at ``audio_scale`` (f32 = i16 / scale)."""

    latents: np.ndarray                 # [B, T_valid, 64]
    sample_rate: int
    time_costs: Dict[str, float]
    seeds: List[int]
    audio_lengths: List[int]
    audio_i16: np.ndarray
    audio_scale: float

    @property
    def audio(self) -> np.ndarray:
        return self.audio_i16.astype(np.float32) / np.float32(self.audio_scale)


class AceStepEngine:
    """Owns the params and configs of the DiT / VAE / text encoder on one device.

    The silence latent (text2music src context) is VAE-encoded once per engine
    and tiled per request."""

    def __init__(self, dit_params, dit_cfg: DiTConfig, vae_params, vae_cfg: VAEConfig,
                 text_params, text_cfg: QwenConfig, device=None, *, dit_mega: bool = False,
                 int8_act: bool = False):
        self.device = resolve_device(device)
        self.dit_mega = dit_mega
        self.int8_act = int8_act
        # stacked decoder layers, fused q||k||v and gate||up, f32 scales once
        self.dit_params = precast_quant_scales(dit.fuse_params(dit.stack_params(dit_params)))
        self.dit_cfg = dit_cfg
        self.vae_params = vae_params
        self.vae_cfg = vae_cfg
        self.text_params = precast_quant_scales(qwen.stack_params(text_params))
        self.text_cfg = text_cfg
        self._silence: Optional[torch.Tensor] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _silence_frames(self, t: int) -> torch.Tensor:
        """[1, t, 64] silence src latents, tiled from a 64-frame encode."""
        if self._silence is None:
            self._silence = vae.silence_latents(self.vae_params, self.vae_cfg, n_frames=64,
                                                chunk_frames=64, device=self.device)
        s = self._silence
        if s.shape[1] >= t:
            return s[:, :t]
        return s.repeat(1, int(math.ceil(t / s.shape[1])), 1)[:, :t]

    def build_condition(self, req: GenerationRequest, b: int):
        style_ids = style_mask = lyric_ids = lyric_mask = None
        if req.lyric_token_ids is not None:
            lyric_ids, lyric_mask = _pad_tokens(req.lyric_token_ids, req.lyric_mask, self.device)
        if req.style_token_ids is not None:
            style_ids, style_mask = _pad_tokens(req.style_token_ids, req.style_mask, self.device)
        enc, mask = encode_condition(self.dit_params, self.text_params, self.dit_cfg,
                                     self.text_cfg, style_ids, style_mask, lyric_ids, lyric_mask)
        if enc.shape[0] == 1 and b > 1:
            enc = enc.expand(b, -1, -1)
            mask = mask.expand(b, -1)
        return enc, mask

    def build_context_latents(self, req: GenerationRequest, b: int, t: int) -> torch.Tensor:
        """context = concat(src latents, chunk mask) along channels; text2music
        uses silence as src and regenerates everywhere (mask 1)."""
        if req.task != "text2music":
            raise NotImplementedError(f"task {req.task!r} is not ported yet")
        cfg = self.dit_cfg
        src_dim = min(cfg.audio_acoustic_hidden_dim, cfg.context_dim)
        src = self._silence_frames(t).expand(b, t, -1)[:, :, :src_dim].float()
        chunk = torch.ones((b, t, cfg.context_dim - src_dim), dtype=torch.float32,
                           device=self.device)
        return torch.cat([src, chunk], dim=-1)

    def make_noise(self, seeds: Sequence[int], t: int) -> torch.Tensor:
        """Per-item seeded standard normal noise [B, t, 64] (torch.Generator on
        the engine's device; not the JAX package's draws)."""
        parts = []
        for s in seeds:
            g = torch.Generator(device=self.device).manual_seed(int(s))
            parts.append(torch.randn((1, t, self.dit_cfg.audio_acoustic_hidden_dim),
                                     generator=g, device=self.device))
        return torch.cat(parts, dim=0)

    @torch.no_grad()
    def generate(self, req: GenerationRequest,
                 noise: Optional[torch.Tensor] = None) -> GenerationResult:
        """text2music for one request.  ``noise [B, T_bucket, 64]`` overrides the
        seeded draw (tests pass the JAX package's noise)."""
        t0 = time.perf_counter()
        time_costs: Dict[str, float] = {}
        b = req.batch_size
        t_valid = frames_for_duration(req.duration_s)
        t = bucket_frames(t_valid)

        enc, enc_mask = self.build_condition(req, b)
        ctx = self.build_context_latents(req, b, t)
        self._sync()
        time_costs["condition_time_cost"] = time.perf_counter() - t0

        seeds = list(req.seeds) if req.seeds else list(range(b))
        seeds = (seeds * b)[:b]
        if noise is None:
            noise = self.make_noise(seeds, t)
        noise = noise.to(self.device, torch.float32)
        attn_mask = None
        if t != t_valid:
            attn_mask = (torch.arange(t, device=self.device)[None, :] < t_valid).to(
                torch.int32).expand(b, -1)
        schedule = sampler.get_timestep_schedule(req.shift, req.timesteps)

        t1 = time.perf_counter()
        latents = sampler.sample_latents(self.dit_params, self.dit_cfg, noise, ctx, enc,
                                         enc_mask, schedule, attn_mask=attn_mask,
                                         dit_mega=self.dit_mega, int8_act=self.int8_act)
        self._sync()
        time_costs["diffusion_time_cost"] = time.perf_counter() - t1
        time_costs["diffusion_per_step_time_cost"] = (
            time_costs["diffusion_time_cost"] / len(schedule))

        latents = torch.nan_to_num(latents, nan=0.0, posinf=0.0, neginf=0.0)
        latents_valid = latents[:, :t_valid]

        t2 = time.perf_counter()
        i16, scale = vae.fused_tiled_decode_int16(
            self.vae_params, self.vae_cfg, latents_valid, chunk_frames=VAE_CHUNK_FRAMES,
            max_window_batch=VAE_WINDOW_BATCH)
        self._sync()
        time_costs["vae_compute_time_cost"] = time.perf_counter() - t2
        t_fetch = time.perf_counter()
        audio_i16 = i16.cpu().numpy().reshape(b, -1, self.vae_cfg.audio_channels)
        audio_scale = float(scale.item())
        latents_np = latents_valid.float().cpu().numpy()
        time_costs["audio_fetch_time_cost"] = time.perf_counter() - t_fetch
        time_costs["vae_time_cost"] = time.perf_counter() - t2
        time_costs["total_time_cost"] = time.perf_counter() - t0
        return GenerationResult(
            latents=latents_np, sample_rate=self.vae_cfg.sampling_rate,
            time_costs=time_costs, seeds=seeds,
            audio_lengths=[t_valid * self.vae_cfg.hop_length] * b,
            audio_i16=audio_i16, audio_scale=audio_scale)


@torch.no_grad()
def build_random_engine(device=None, quant: Optional[str] = "q8_0", seed: int = 0,
                        dit_cfg: Optional[DiTConfig] = None,
                        vae_cfg: Optional[VAEConfig] = None,
                        text_cfg: Optional[QwenConfig] = None, *, dit_mega: bool = False,
                        int8_act: bool = False) -> AceStepEngine:
    """Random-weight engine (full width by default), initialised and quantized
    on ``device`` with a seeded torch.Generator there.  ``quant``: q8_0, q4_0,
    q4_k, q6_k, or None for bf16 kernels; ``dit_mega`` / ``int8_act`` as
    :class:`AceStepEngine`."""
    dev = resolve_device(device)
    dit_cfg, vae_cfg, text_cfg = dit_cfg or DiTConfig(), vae_cfg or VAEConfig(), \
        text_cfg or QwenConfig()
    init = RandomInit(dev, seed, quant)
    return AceStepEngine(init.dit(dit_cfg), dit_cfg, init.vae(vae_cfg), vae_cfg,
                         init.qwen(text_cfg), text_cfg, device=dev, dit_mega=dit_mega,
                         int8_act=int8_act)
