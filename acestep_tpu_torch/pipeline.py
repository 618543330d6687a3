"""End-to-end generation pipeline on the card: port of the JAX package's
pipeline.py, every task of its engine.

Flow:
  style tokens -> Qwen3 text encoder -> text_projector       \\
  lyric tokens -> Qwen embeddings -> DiT lyric encoder        > pack [lyric | timbre | style]
  refer latents -> DiT timbre encoder (one token a clip)     /
  context_latents = concat(src latents, chunk mask): silence and 1 everywhere
    for text2music; the source for cover / extract / complete / spanless
    lego; the source with its span silenced and masked for repaint and lego
    with a span
  8-step turbo Euler loop (DiT; cover switches to the non-cover condition
    after ``round(steps * strength)`` steps), or the base model's CFG / ADG
    loop when ``guidance_scale != 1``
  tiled VAE decode -> int16 waveform at the global peak scale

Source and reference audio reach the engine as latents: ``encode_src_audio``
and ``encode_refer_audio`` VAE-encode a waveform in 128-frame windows.

Latent lengths are bucketed (frames rounded up to FRAME_BUCKET); each item's
validity (``durations_s``: a batch may mix durations in one bucket) is carried
by the attention mask and trailing frames are sliced off before the decode.
The memory planner (memory_planner.py) clamps the batch before launch and
picks the decode chunk and window batch.  A batch-1 song of two or more decode
windows is decoded in segments, each quantized at its own scale and then
reconciled to the lowest (``segment_windows``, ``reconcile_segments``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for the card where there is none raises.

``AceStepEngine(mesh=)`` serves from a (dp, tp) group of processes, one a
rank, every rank calling ``generate`` with the same request and returning the
same result (parallel/): the DiT is tensor-parallel over tp (unfused; the
lyric and timbre encoders too), the text encoder and the VAE are replicated,
a batch splits over dp where dp divides it (pipeline.py:640-695), and the VAE
decode deals its windows over every rank (``vae_shard``, the JAX package's
``ACESTEP_TPU_VAE_SHARD``).

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
    FRAME_BUCKET, LATENT_RATE, MAX_DURATION_S, MIN_DURATION_S, TIMBRE_FIX_FRAMES,
    TOKEN_BUCKETS,
)
from acestep_tpu_torch.models import dit, qwen, vae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.qlinear import precast_quant_scales

SEGMENT_FRAMES = 2048       # latent frames a decode segment aims at (pipeline.py:239-250)


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` means the card (under a ``mesh``, this rank's card); a CUDA
    device without a card raises."""
    if device is None and mesh is not None:
        device = mesh.device
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
    """Concatenate (hidden [B, L_i, H], mask [B, L_i]) parts along L (in the
    promoted dtype: f32 when the timbre tokens are among them), then
    stable-partition each row so valid tokens come first."""
    dt = parts[0][0].dtype
    for h, _ in parts[1:]:
        dt = torch.promote_types(dt, h.dtype)
    hidden = torch.cat([h.to(dt) for h, _ in parts], dim=1)
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
                    plan: memory_planner.Plan, group=None):
    """[B, T, C] latents decoded in one pass at the plan's chunk and window
    batch: (int16 [B, L * channels], scale), on the device; ``group`` deals
    the windows over its ranks (models/vae.py)."""
    return vae.fused_tiled_decode_int16(vae_params, vae_cfg, latents,
                                        chunk_frames=decode_chunk(plan),
                                        max_window_batch=plan.vae_window_batch, group=group)


def decode_segments(vae_params, vae_cfg: VAEConfig, latents: torch.Tensor,
                    plan: memory_planner.Plan, group=None):
    """The segmented decode (pipeline.py:724-822) of [1, T, C] latents,
    launched on the device: one (int16, scale) a segment, each at its own
    scale; [] when the plan's chunk cuts fewer than two windows.  ``group``
    as :func:`decode_one_pass`."""
    chunk, t = decode_chunk(plan), latents.shape[1]
    windows = vae._window_plan(t, chunk, None) if chunk < t else []
    if len(windows) < 2:
        return []
    return [vae.fused_decode_windows_int16(vae_params, vae_cfg, latents[:, lo:hi], rel,
                                           max_window_batch=plan.vae_window_batch,
                                           group=group)
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


def fold_seed(seed: int, index: int) -> int:
    """A seed of its own for stream ``index`` of ``seed`` (under a dp split,
    the JAX package's ``fold_in`` of the dp index, tp.py:132; not its bits)."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


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
                     style_ids, style_mask, lyric_ids, lyric_mask, refer_latents=None,
                     refer_frame_mask=None, refer_clip_mask=None, *, group=None):
    """Lyric + timbre + style condition -> (packed_hidden [B, Ll+n+Ls, H],
    packed_mask) (pipeline.py:94-117).  ``refer_latents`` [B, n, Lr, C] with
    its frame mask [B, n, Lr] gives one timbre token a clip, valid where
    ``refer_clip_mask`` [B, n] is 1.  ``group``: the lyric and timbre encoders
    tensor-parallel (``dit_params`` and ``dit_cfg`` local), the text encoder
    replicated."""
    parts = []
    if lyric_ids is not None:
        emb = qwen.embeddings_only(text_params, lyric_ids)
        parts.append((dit.lyric_encoder(dit_params, dit_cfg, emb, lyric_mask, group),
                      lyric_mask))
    if refer_latents is not None:
        b, n, lr, c = refer_latents.shape
        fm = None if refer_frame_mask is None else refer_frame_mask.reshape(b * n, lr)
        toks = dit.timbre_encoder(dit_params, dit_cfg, refer_latents.reshape(b * n, lr, c), fm,
                                  group)
        parts.append((toks.reshape(b, n, -1), refer_clip_mask))
    if style_ids is not None:
        hs = qwen.forward(text_params, text_cfg, style_ids, style_mask)
        parts.append((dit.text_projector(dit_params, hs), style_mask))
    if not parts:
        raise ValueError("empty condition: need style, lyric or timbre input")
    return pack_sequences(parts)


@dataclasses.dataclass
class GenerationRequest:
    """One request, pre-tokenized (the JAX package's fields).  ``durations_s``
    gives each item of a batch its own duration (configs[3]'s mixed-duration
    batches share one frame bucket); unset, every item lasts ``duration_s``.
    ``guidance_scale != 1`` selects the base model's CFG loop over an
    ``infer_steps``-long shifted schedule."""

    duration_s: float = 30.0
    style_token_ids: Optional[np.ndarray] = None      # [B, Ls]
    style_mask: Optional[np.ndarray] = None
    lyric_token_ids: Optional[np.ndarray] = None      # [B, Ll]
    lyric_mask: Optional[np.ndarray] = None
    refer_latents: Optional[np.ndarray] = None        # [B, n_refer, Lr, 64]
    refer_mask: Optional[np.ndarray] = None           # [B, n_refer]
    task: str = "text2music"      # text2music | repaint | cover | extract | lego | complete
    src_latents: Optional[np.ndarray] = None          # [B, T, 64] source latents
    repaint_start_s: float = 0.0
    repaint_end_s: float = -1.0                       # -1: to the end
    audio_cover_strength: float = 1.0
    track_name: Optional[str] = None                  # extract / lego target track
    complete_track_classes: Optional[Sequence[str]] = None
    seeds: Optional[Sequence[int]] = None
    shift: float = 3.0
    timesteps: Optional[Sequence[float]] = None
    infer_method: str = "ode"                         # "ode" or "sde"
    batch_size: int = 1
    guidance_scale: float = 1.0
    infer_steps: int = 8
    cfg_interval_start: float = 0.0
    cfg_interval_end: float = 1.0
    use_adg: bool = False
    uncond_style_token_ids: Optional[np.ndarray] = None   # negative-prompt tokens
    uncond_style_mask: Optional[np.ndarray] = None
    durations_s: Optional[Sequence[float]] = None


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
    """Owns the params and configs of the DiT / VAE / text encoder on one device
    (on each rank's device under a ``mesh``, this rank's DiT shards).

    The silence latent (text2music src context) is VAE-encoded once per engine
    and tiled per request."""

    def __init__(self, dit_params, dit_cfg: DiTConfig, vae_params, vae_cfg: VAEConfig,
                 text_params, text_cfg: QwenConfig, device=None, *, dit_mega: bool = False,
                 int8_act: bool = False, mesh=None, vae_shard: bool = True):
        self.device = resolve_device(device, mesh)
        self.dit_mega = dit_mega
        self.int8_act = int8_act
        self.dit_cfg = dit_cfg
        self.vae_cfg = vae_cfg
        self.text_cfg = text_cfg
        self.mesh = mesh
        # stacked decoder layers, fused q||k||v and gate||up (exact), f32 scales
        # once; under tensor parallelism the per-projection weights are
        # column-sharded instead (pipeline.py:315-347)
        self.dit_params = dit.stack_params(dit_params)
        if mesh is None or mesh.tp == 1:
            self.dit_params = dit.fuse_params(self.dit_params)
        self.dit_params = precast_quant_scales(self.dit_params)
        self.vae_params = vae_params
        self.text_params = precast_quant_scales(qwen.stack_params(text_params))
        if mesh is None:
            self.run_cfg, self.group, self._tp, self._vae_group = dit_cfg, None, None, None
        else:
            from acestep_tpu_torch.parallel import sharding, tp

            self.dit_params = sharding.shard_params(self.dit_params, mesh)
            self.text_params = sharding.replicate(self.text_params, mesh)
            self.vae_params = sharding.replicate(self.vae_params, mesh)
            self.run_cfg, self.group = tp.local_cfg(dit_cfg, mesh.tp), mesh.tp_group
            self._tp = {"sampler": tp.make_tp_sampler(dit_cfg, mesh),
                        "cfg_sampler": tp.make_tp_cfg_sampler(dit_cfg, mesh),
                        "condition": tp.make_tp_condition(dit_cfg, text_cfg, mesh)}
            self._vae_group = mesh.world if vae_shard and mesh.world_size > 1 else None
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

    @torch.no_grad()
    def _silence_frames(self, t: int) -> torch.Tensor:
        """[1, t, 64] silence src latents, tiled from a 64-frame encode."""
        if self._silence is None:
            self._silence = vae.silence_latents(self.vae_params, self.vae_cfg, n_frames=64,
                                                chunk_frames=64, device=self.device)
        s = self._silence
        if s.shape[1] >= t:
            return s[:, :t]
        return s.repeat(1, int(math.ceil(t / s.shape[1])), 1)[:, :t]

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(self.device, dtype)

    def encode_timbre(self, refer_latents, refer_mask=None):
        """Reference latents [B, n, Lr, 64] -> (timbre tokens [B, n, H], clip
        mask [B, n], ones unless given), every frame valid (pipeline.py:407-419)."""
        b, n, lr, c = np.asarray(refer_latents).shape
        toks = dit.timbre_encoder(self.dit_params, self.run_cfg,
                                  self._tensor(refer_latents).reshape(b * n, lr, c),
                                  group=self.group)
        mask = (torch.ones((b, n), dtype=torch.int32, device=self.device) if refer_mask is None
                else self._tensor(refer_mask, torch.int32))
        return toks.reshape(b, n, -1), mask

    def build_condition(self, req: GenerationRequest, b: int):
        """Pack [lyric | timbre | style] valid tokens first (pipeline.py:407-459):
        each reference clip zero-padded or cut to TIMBRE_FIX_FRAMES with its
        frame mask, the clip mask ones unless given."""
        style_ids = style_mask = lyric_ids = lyric_mask = None
        refer = refer_fm = refer_cm = None
        if req.lyric_token_ids is not None:
            lyric_ids, lyric_mask = _pad_tokens(req.lyric_token_ids, req.lyric_mask, self.device)
        if req.refer_latents is not None:
            r = np.asarray(req.refer_latents, np.float32)
            bb, n, lr, _ = r.shape
            fm = np.ones((bb, n, lr), np.int32)
            if lr < TIMBRE_FIX_FRAMES:
                widths = ((0, 0), (0, 0), (0, TIMBRE_FIX_FRAMES - lr))
                r = np.pad(r, widths + ((0, 0),))
                fm = np.pad(fm, widths)
            refer = self._tensor(r[:, :, :TIMBRE_FIX_FRAMES])
            refer_fm = self._tensor(fm[:, :, :TIMBRE_FIX_FRAMES], torch.int32)
            refer_cm = self._tensor(np.ones((bb, n), np.int32) if req.refer_mask is None
                                    else np.asarray(req.refer_mask, np.int32), torch.int32)
        if req.style_token_ids is not None:
            style_ids, style_mask = _pad_tokens(req.style_token_ids, req.style_mask, self.device)
        args = (style_ids, style_mask, lyric_ids, lyric_mask, refer, refer_fm, refer_cm)
        if self._tp is not None:
            enc, mask = self._tp["condition"](self.dit_params, self.text_params, *args)
        else:
            enc, mask = encode_condition(self.dit_params, self.text_params, self.dit_cfg,
                                         self.text_cfg, *args)
        if enc.shape[0] == 1 and b > 1:
            enc, mask = enc.expand(b, -1, -1), mask.expand(b, -1)
        return enc, mask

    def build_context_latents(self, req: GenerationRequest, b: int, t: int,
                              t_valid: Optional[int] = None) -> torch.Tensor:
        """context = concat(src latents, chunk mask) along channels
        (pipeline.py:463-507; chunk mask 1 = regenerate here).

        text2music, or no source: silence, mask 1.  repaint, and lego with
        ``repaint_end_s > repaint_start_s``: the span ``[int(start * 25),
        min(end, t_valid))`` (``end`` = ``t_valid`` for ``repaint_end_s < 0``)
        has mask 1 and the silence latents in place of the source; mask 0
        elsewhere.  cover, extract, complete and spanless lego: the source,
        mask 1.  The source is zero-padded or cut to ``t`` frames."""
        cfg = self.dit_cfg
        t_valid = t if t_valid is None else t_valid
        src_dim = min(cfg.audio_acoustic_hidden_dim, cfg.context_dim)
        mask_dim = cfg.context_dim - src_dim
        sil = self._silence_frames(t).expand(b, t, -1)[:, :, :src_dim].float()
        chunk = torch.ones((b, t, mask_dim), dtype=torch.float32, device=self.device)
        if req.task == "text2music" or req.src_latents is None:
            return torch.cat([sil, chunk], dim=-1)
        src = self._tensor(req.src_latents)
        if src.shape[1] < t:
            src = torch.nn.functional.pad(src, (0, 0, 0, t - src.shape[1]))
        src = src[:, :t, :src_dim].expand(b, t, src_dim)
        if req.task == "repaint" or (req.task == "lego"
                                     and req.repaint_end_s > req.repaint_start_s):
            start = int(req.repaint_start_s * LATENT_RATE)
            end = t_valid if req.repaint_end_s < 0 else int(req.repaint_end_s * LATENT_RATE)
            frames = torch.arange(t, device=self.device)
            inside = ((frames >= start) & (frames < min(end, t_valid)))[None, :, None]
            chunk = inside.float().expand(b, t, mask_dim)
            src = torch.where(inside, sil, src)
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

    def _stereo(self, audio) -> np.ndarray:
        """A waveform [L] or [L, C] as f32 [L, channels] (mono repeated)."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[:, None]
        if audio.shape[1] == 1:
            audio = np.repeat(audio, self.vae_cfg.audio_channels, axis=1)
        return audio

    @torch.no_grad()
    def _encode_audio(self, audio: np.ndarray, max_frames: Optional[int] = None) -> torch.Tensor:
        """Whole latent frames of a stereo waveform (at most ``max_frames``),
        VAE-encoded in 128-frame windows of 32 overlap: [1, T, 64] on the device."""
        hop = self.vae_cfg.hop_length
        frames = audio.shape[0] // hop
        t_frames = max(1, frames if max_frames is None else min(frames, max_frames))
        return vae.tiled_encode(self.vae_params, self.vae_cfg,
                                self._tensor(audio[None, :t_frames * hop]),
                                chunk_frames=128, overlap_frames=32)

    def encode_src_audio(self, audio) -> np.ndarray:
        """Source waveform [L, C] (or mono [L]) -> src latents [1, T, 64] for
        the repaint / cover / extract / lego / complete tasks, every frame kept
        (pipeline.py:887-904)."""
        return self._encode_audio(self._stereo(audio)).cpu().numpy()

    def encode_refer_audio(self, audios, max_frames: Optional[int] = None) -> np.ndarray:
        """Reference clips -> timbre latents [1, n, Lr, 64]: each clip encoded
        and cut to ``max_frames`` (TIMBRE_FIX_FRAMES, 30 s), the clips
        zero-padded to the longest (pipeline.py:906-936)."""
        max_frames = max_frames or TIMBRE_FIX_FRAMES
        clips = [self._encode_audio(self._stereo(a), max_frames)[0].cpu().numpy()
                 for a in audios]
        out = np.zeros((1, len(clips), max(c.shape[0] for c in clips), clips[0].shape[1]),
                       np.float32)
        for i, c in enumerate(clips):
            out[0, i, :c.shape[0]] = c
        return out

    def lyric_attention_map(self, latents, req: GenerationRequest,
                            eps: Optional[torch.Tensor] = None) -> Tuple[np.ndarray, int]:
        """The alignment probe of generated ``latents`` [B, T_valid, 64] under
        ``req``'s condition (pipeline.py:940-1003): the latents zero-padded to
        their frame bucket, ``build_condition`` and ``build_context_latents``,
        then ``alignment.cross_attention_maps`` (``eps`` of the padded shape,
        seeded by default).  Returns (item 0's map [Tp, Lc] f32, the lyric
        token count)."""
        from acestep_tpu_torch import alignment

        if self.mesh is not None:
            raise NotImplementedError("the lyric alignment probe runs on an unmeshed engine")
        if req.lyric_token_ids is None:
            raise ValueError("request has no lyric tokens to align")
        lat = self._tensor(latents)
        b, t_valid = lat.shape[0], lat.shape[1]
        t = bucket_frames(t_valid)
        if t != t_valid:
            lat = torch.nn.functional.pad(lat, (0, 0, 0, t - t_valid))
        enc, enc_mask = self.build_condition(req, b)
        ctx = self.build_context_latents(req, b, t, t_valid)
        maps = alignment.cross_attention_maps(self.dit_params, self.dit_cfg, lat, ctx, enc,
                                              enc_mask, eps=eps)
        n_lyric = (int(np.asarray(req.lyric_mask).sum(axis=1)[0]) if req.lyric_mask is not None
                   else int(np.asarray(req.lyric_token_ids).shape[1]))
        return maps[0].cpu().numpy(), n_lyric

    def get_lyric_timestamps(self, latents, req: GenerationRequest,
                             lyric_lines: Optional[Sequence[str]] = None,
                             line_token_counts: Optional[Sequence[int]] = None,
                             eps: Optional[torch.Tensor] = None):
        """Each lyric token's time (s) in the generated ``latents``, from the
        probe and DTW: (stamps [n_lyric], the LRC text or None)."""
        from acestep_tpu_torch import alignment

        attn, n_lyric = self.lyric_attention_map(latents, req, eps)
        stamps = alignment.token_timestamps(attn, n_lyric, self.dit_cfg.patch_size / LATENT_RATE)
        lrc = None
        if lyric_lines is not None and line_token_counts is not None:
            lrc = alignment.to_lrc(lyric_lines, line_token_counts, stamps)
        return stamps, lrc

    def get_lyric_score(self, latents, req: GenerationRequest,
                        eps: Optional[torch.Tensor] = None) -> float:
        """Lyric-alignment quality score (on-path attention mass ratio)."""
        from acestep_tpu_torch import alignment

        return alignment.alignment_score(*self.lyric_attention_map(latents, req, eps))

    def cover_switch(self, req: GenerationRequest, b: int, t: int, t_valid: int,
                     n_steps: int, enc, enc_mask) -> Dict[str, object]:
        """The cover task's switch (pipeline.py:588-614) as ``sample_latents``
        keywords, or {} when ``req`` has none: for ``0 <= strength < 1``, after
        ``round(n_steps * strength)`` steps the condition with its timbre
        clips masked out and the silence context."""
        if req.task != "cover" or not 0.0 <= req.audio_cover_strength < 1.0:
            return {}
        enc_nc, mask_nc = enc, enc_mask
        if req.refer_latents is not None:
            shape = np.asarray(req.refer_latents).shape[:2]
            enc_nc, mask_nc = self.build_condition(
                dataclasses.replace(req, refer_mask=np.zeros(shape, np.int32)), b)
        ctx_nc = self.build_context_latents(
            dataclasses.replace(req, task="text2music", src_latents=None), b, t, t_valid)
        return dict(cover_steps=int(round(n_steps * req.audio_cover_strength)),
                    encoder_hidden_states_non_cover=enc_nc, context_latents_non_cover=ctx_nc,
                    encoder_attn_mask_non_cover=mask_nc)

    def uncond_condition(self, req: GenerationRequest, b: int, enc, enc_mask):
        """The CFG loop's uncond condition: ``uncond_style_token_ids`` alone
        (no lyric, no timbre), else the same packed condition with a zero mask."""
        if req.uncond_style_token_ids is None:
            return enc, torch.zeros_like(enc_mask)
        return self.build_condition(dataclasses.replace(
            req, style_token_ids=req.uncond_style_token_ids, style_mask=req.uncond_style_mask,
            lyric_token_ids=None, lyric_mask=None, refer_latents=None, refer_mask=None), b)

    @torch.no_grad()
    def generate(self, req: GenerationRequest, noise: Optional[torch.Tensor] = None,
                 sde_noise: Optional[torch.Tensor] = None) -> GenerationResult:
        """One request of any task (pipeline.py:528-863).  ``noise [B,
        T_bucket, 64]`` overrides the seeded draw (tests pass the JAX
        package's noise); so does ``sde_noise [n_steps, B, T_bucket, 64]`` for
        the SDE sampler's per-step draws, which otherwise come from a
        generator seeded with the first seed.  The cover switch's and the CFG
        uncond's conditions count in ``condition_time_cost``."""
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

        use_cfg = req.guidance_scale != 1.0
        schedule = (sampler.get_base_timestep_schedule(req.infer_steps, req.shift) if use_cfg
                    else sampler.get_timestep_schedule(req.shift, req.timesteps))
        enc, enc_mask = self.build_condition(req, b)
        ctx = self.build_context_latents(req, b, t, t_valid)
        if use_cfg:
            enc_u, enc_u_mask = self.uncond_condition(req, b, enc, enc_mask)
        else:
            cover_kw = self.cover_switch(req, b, t, t_valid, len(schedule), enc, enc_mask)
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

        t1 = time.perf_counter()
        # under a mesh the batch splits over dp where dp divides it
        # (pipeline.py:640-695); each dp row block draws its own SDE noise
        split = self.mesh is not None and self.mesh.dp > 1 and b % self.mesh.dp == 0
        sde_gen = None
        if req.infer_method == "sde" and sde_noise is None:
            sde_gen = torch.Generator(device=self.device).manual_seed(
                fold_seed(int(seeds[0]), self.mesh.dp_rank) if split else int(seeds[0]))
        if use_cfg:
            kw = dict(guidance_scale=req.guidance_scale,
                      cfg_interval_start=req.cfg_interval_start,
                      cfg_interval_end=req.cfg_interval_end, use_adg=req.use_adg,
                      infer_method=req.infer_method, sde_noise=sde_noise, sde_generator=sde_gen,
                      attn_mask=attn_mask, int8_act=self.int8_act)
            if self._tp is not None:
                latents = self._tp["cfg_sampler"](
                    self.dit_params, noise, ctx, enc, enc_mask, enc_u, enc_u_mask, schedule,
                    batch_sharded=split, **kw)
            else:
                latents = sampler.sample_latents_cfg(
                    self.dit_params, self.dit_cfg, noise, ctx, enc, enc_mask, enc_u,
                    enc_u_mask, schedule, **kw)
        else:
            kw = dict(attn_mask=attn_mask, dit_mega=self.dit_mega, int8_act=self.int8_act,
                      infer_method=req.infer_method, sde_noise=sde_noise, sde_generator=sde_gen,
                      **cover_kw)
            if self._tp is not None:
                latents = self._tp["sampler"](self.dit_params, noise, ctx, enc, enc_mask,
                                              schedule, batch_sharded=split, **kw)
            else:
                latents = sampler.sample_latents(self.dit_params, self.dit_cfg, noise, ctx,
                                                 enc, enc_mask, schedule, **kw)
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
        handles = (decode_segments(self.vae_params, self.vae_cfg, latents_valid, plan,
                                   self._vae_group) if b == 1 else [])
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

        i16, scale = decode_one_pass(self.vae_params, self.vae_cfg, latents_valid, plan,
                                     self._vae_group)
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
                        int8_act: bool = False, mesh=None, vae_shard: bool = True
                        ) -> AceStepEngine:
    """Random-weight engine (full width by default), initialised and quantized
    on ``device`` with a seeded torch.Generator there.  ``quant``: q8_0, q4_0,
    q4_k, q6_k, or None for bf16 kernels; ``dit_mega`` / ``int8_act`` /
    ``mesh`` / ``vae_shard`` as :class:`AceStepEngine`.  Under a mesh every
    rank draws the whole trees from the same seed on its own device (equal
    weights on every rank of one device type) and keeps its DiT shards; the
    whole DiT tree lives only until the engine has cut it."""
    dev = resolve_device(device, mesh)
    dit_cfg, vae_cfg, text_cfg = dit_cfg or DiTConfig(), vae_cfg or VAEConfig(), \
        text_cfg or QwenConfig()
    init = RandomInit(dev, seed, quant)
    return AceStepEngine(init.dit(dit_cfg), dit_cfg, init.vae(vae_cfg), vae_cfg,
                         init.qwen(text_cfg), text_cfg, device=dev, dit_mega=dit_mega,
                         int8_act=int8_act, mesh=mesh, vae_shard=vae_shard)
