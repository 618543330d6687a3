"""End-to-end text2music pipeline on the card: port of the JAX package's
pipeline.py main path.

Flow:
  style tokens -> Qwen3 text encoder -> text_projector       \\
  lyric tokens -> Qwen embeddings -> DiT lyric encoder        > pack [lyric | style]
  context_latents = concat(silence src latents, chunk mask)
  8-step flow-matching Euler loop (DiT)
  tiled VAE decode -> int16 waveform at the global peak scale

Latent lengths are bucketed (frames rounded up to FRAME_BUCKET); each item's
validity (``durations_s``: a batch may mix durations in one bucket) is carried
by the attention mask and trailing frames are sliced off before the decode.
The memory planner (memory_planner.py) clamps the batch before launch and
picks the decode chunk and window batch.  A batch-1 song of two or more decode
windows is decoded in segments, each quantized at its own scale and then
reconciled to the lowest (``segment_windows``, ``reconcile_segments``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the card where there is none raises.

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
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch import memory_planner, sampler
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.constants import (
    FRAME_BUCKET, LATENT_RATE, MAX_DURATION_S, MIN_DURATION_S, TOKEN_BUCKETS,
)
from acestep_tpu_torch.models import dit, qwen, vae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.qlinear import precast_quant_scales

SEGMENT_FRAMES = 2048       # latent frames a decode segment aims at (pipeline.py:239-250)


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


def segment_windows(windows, chunk_frames: int):
    """The segmented decode's plan (pipeline.py:724-822): the decode windows
    cut into segments of ``min(max(2, SEGMENT_FRAMES // chunk), len // 2)``
    windows, each as (latent start, latent end, windows relative to it)."""
    n = min(max(2, SEGMENT_FRAMES // chunk_frames), len(windows) // 2)
    out = []
    for s0 in range(0, len(windows), n):
        seg = windows[s0:s0 + n]
        lo, hi = seg[0][2], seg[-1][3]
        out.append((lo, hi, [(cs - lo, ce - lo, ws - lo, we - lo) for cs, ce, ws, we in seg]))
    return out


def decode_chunk(plan: memory_planner.Plan) -> int:
    """The plan's VAE decode chunk, clamped to [32, 512]."""
    return int(min(max(plan.vae_chunk_frames, 32), 512))


def decode_one_pass(vae_params, vae_cfg: VAEConfig, latents: torch.Tensor,
                    plan: memory_planner.Plan):
    """[B, T, C] latents decoded in one pass at the plan's chunk and window
    batch: (int16 [B, L * channels], scale), on the device."""
    return vae.fused_tiled_decode_int16(vae_params, vae_cfg, latents,
                                        chunk_frames=decode_chunk(plan),
                                        max_window_batch=plan.vae_window_batch)


def decode_segments(vae_params, vae_cfg: VAEConfig, latents: torch.Tensor,
                    plan: memory_planner.Plan):
    """The segmented decode (pipeline.py:724-822) of [1, T, C] latents,
    launched on the device: one (int16, scale) a segment, each at its own
    scale; [] when the plan's chunk cuts fewer than two windows."""
    chunk, t = decode_chunk(plan), latents.shape[1]
    windows = vae._window_plan(t, chunk, None) if chunk < t else []
    if len(windows) < 2:
        return []
    return [vae.fused_decode_windows_int16(vae_params, vae_cfg, latents[:, lo:hi], rel,
                                           max_window_batch=plan.vae_window_batch)
            for lo, hi, rel in segment_windows(windows, chunk)]


def reconcile_segments(fetched, channels: int):
    """Segments decoded at their own scales -> ([1, L_g, C] int16 segments at
    the lowest scale, that scale).  A segment whose peak passed 0.99 is
    re-quantized as ``round(i16 * (scale / s_g))``: at most one step of double
    rounding."""
    scale = min(s_g for _, s_g in fetched)
    segments = []
    for i16_g, s_g in fetched:
        seg = i16_g.reshape(1, -1, channels)
        if s_g != scale:
            seg = np.round(seg.astype(np.float32) * (scale / s_g)).astype(np.int16)
        segments.append(seg)
    return segments, scale


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
    """One text2music request, pre-tokenized.  ``durations_s`` gives each item
    of a batch its own duration (configs[3]'s mixed-duration batches share one
    frame bucket); unset, every item lasts ``duration_s``."""

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
    durations_s: Optional[Sequence[float]] = None
    infer_method: str = "ode"                         # "ode" or "sde"


class GenerationResult:
    """16-bit PCM at ``audio_scale`` (f32 = i16 / scale).  A segmented decode
    keeps its time-contiguous segments (``pcm16_segments()``); ``audio_i16
    [B, L, C]`` concatenates them on first use.  ``audio_lengths`` holds each
    item's valid samples (a merged batch pads shorter items to its longest)."""

    def __init__(self, latents: np.ndarray, sample_rate: int, time_costs: Dict[str, float],
                 seeds: List[int], audio_lengths: List[int], audio_scale: float,
                 audio_i16: Optional[np.ndarray] = None,
                 audio_i16_segments: Optional[List[np.ndarray]] = None):
        self.latents = latents                  # [B, T_valid, 64]
        self.sample_rate = sample_rate
        self.time_costs = time_costs
        self.seeds = seeds
        self.audio_lengths = audio_lengths
        self.audio_scale = float(audio_scale)
        self._audio_i16 = audio_i16
        self._segments = audio_i16_segments

    @property
    def audio_i16(self) -> np.ndarray:
        if self._audio_i16 is None:
            self._audio_i16 = np.concatenate(self._segments, axis=1)
        return self._audio_i16

    def pcm16_segments(self) -> List[np.ndarray]:
        """Time-contiguous int16 segments [B, L_g, C] (one when whole)."""
        return self._segments if self._segments is not None else [self.audio_i16]

    @property
    def audio(self) -> np.ndarray:
        return np.multiply(self.audio_i16, np.float32(1.0 / self.audio_scale),
                           dtype=np.float32)


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
        self._param_bytes: Optional[int] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def plan(self, batch: int, frames: int) -> memory_planner.Plan:
        """The memory plan of ``batch`` items of ``frames`` latent frames on
        this engine's device."""
        if self._param_bytes is None:
            self._param_bytes = (memory_planner.tree_bytes(self.dit_params)
                                 + memory_planner.tree_bytes(self.vae_params))
        return memory_planner.plan_request(
            self.dit_cfg, self.vae_cfg, self._param_bytes, batch, frames,
            memory_planner.detect_device_bytes(self.device))

    def max_batch_for_frames(self, frames: int) -> int:
        """Admission cap at the frame bucket of ``frames``: the continuous
        batcher's ``max_batch_for``, so a merge never exceeds what the plan
        admits (the engine's own clamp would truncate a merged request)."""
        return max(1, self.plan(64, bucket_frames(frames)).max_batch)

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
    def generate(self, req: GenerationRequest, noise: Optional[torch.Tensor] = None,
                 sde_noise: Optional[torch.Tensor] = None) -> GenerationResult:
        """text2music for one request (pipeline.py:528-863).  ``noise [B,
        T_bucket, 64]`` overrides the seeded draw (tests pass the JAX
        package's noise); so does ``sde_noise [n_steps, B, T_bucket, 64]`` for
        the SDE sampler's per-step draws, which otherwise come from a
        generator seeded with the first seed."""
        t0 = time.perf_counter()
        time_costs: Dict[str, float] = {}
        b = req.batch_size
        # admission control: clamp the batch before launch rather than run
        # out of memory mid-flight
        plan = self.plan(b, frames_for_duration(req.duration_s))
        if plan.max_batch < b:
            warnings.warn(f"memory planner clamped batch {b} -> {plan.max_batch} "
                          f"({plan.detail})", stacklevel=2)
            b = plan.max_batch
        durations = list(req.durations_s) if req.durations_s else [req.duration_s] * b
        durations = (durations * b)[:b]
        item_valid = [frames_for_duration(d) for d in durations]
        t_valid = max(item_valid)
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
        if t != t_valid or len(set(item_valid)) > 1:
            valid = torch.tensor(item_valid, dtype=torch.int64, device=self.device)[:, None]
            attn_mask = (torch.arange(t, device=self.device)[None, :] < valid).to(torch.int32)
        schedule = sampler.get_timestep_schedule(req.shift, req.timesteps)

        t1 = time.perf_counter()
        sde_gen = None
        if req.infer_method == "sde" and sde_noise is None:
            sde_gen = torch.Generator(device=self.device).manual_seed(int(seeds[0]))
        latents = sampler.sample_latents(self.dit_params, self.dit_cfg, noise, ctx, enc,
                                         enc_mask, schedule, attn_mask=attn_mask,
                                         dit_mega=self.dit_mega, int8_act=self.int8_act,
                                         infer_method=req.infer_method, sde_noise=sde_noise,
                                         sde_generator=sde_gen)
        self._sync()
        time_costs["diffusion_time_cost"] = time.perf_counter() - t1
        time_costs["diffusion_per_step_time_cost"] = (
            time_costs["diffusion_time_cost"] / len(schedule))

        latents = torch.nan_to_num(latents, nan=0.0, posinf=0.0, neginf=0.0)
        latents_valid = latents[:, :t_valid]
        audio_lengths = [v * self.vae_cfg.hop_length for v in item_valid]
        channels = self.vae_cfg.audio_channels

        t2 = time.perf_counter()
        # segmented decode: segments of about SEGMENT_FRAMES (at least two
        # windows), each quantized at its own scale, then reconciled
        handles = (decode_segments(self.vae_params, self.vae_cfg, latents_valid, plan)
                   if b == 1 else [])
        if handles:
            self._sync()
            time_costs["vae_compute_time_cost"] = time.perf_counter() - t2
            t_fetch = time.perf_counter()
            fetched = [(i16_g.cpu().numpy(), float(s_g)) for i16_g, s_g in handles]
            latents_np = latents_valid.float().cpu().numpy()
            time_costs["audio_fetch_time_cost"] = time.perf_counter() - t_fetch
            segments, scale = reconcile_segments(fetched, channels)
            time_costs["vae_time_cost"] = time.perf_counter() - t2
            time_costs["vae_overlapped"] = 1.0
            time_costs["total_time_cost"] = time.perf_counter() - t0
            return GenerationResult(
                latents=latents_np, sample_rate=self.vae_cfg.sampling_rate,
                time_costs=time_costs, seeds=seeds, audio_lengths=audio_lengths,
                audio_scale=scale, audio_i16_segments=segments)

        i16, scale = decode_one_pass(self.vae_params, self.vae_cfg, latents_valid, plan)
        self._sync()
        time_costs["vae_compute_time_cost"] = time.perf_counter() - t2
        t_fetch = time.perf_counter()
        audio_i16 = i16.cpu().numpy().reshape(b, -1, channels)
        audio_scale = float(scale.item())
        latents_np = latents_valid.float().cpu().numpy()
        time_costs["audio_fetch_time_cost"] = time.perf_counter() - t_fetch
        time_costs["vae_time_cost"] = time.perf_counter() - t2
        time_costs["total_time_cost"] = time.perf_counter() - t0
        return GenerationResult(
            latents=latents_np, sample_rate=self.vae_cfg.sampling_rate,
            time_costs=time_costs, seeds=seeds, audio_lengths=audio_lengths,
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
