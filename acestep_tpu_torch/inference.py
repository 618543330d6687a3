"""Public orchestration API (port of the JAX package's inference.py).

``generate_music``: the optional LM phase (CoT metadata + 5 Hz codes) ->
metadata merge -> PMI ranking of the candidates -> DiT diffusion + VAE decode
-> audio, for every task of the engine (an unknown task name means
text2music, as in the JAX package), with source and reference latents passed
through.  With codec parameters, a text2music request with LM codes becomes a
cover of the codes' 25 Hz latent hints (``models/codec.codes_to_latents``).
``understand_audio``: a waveform -> 5 Hz codes (VAE encode, codec tokenize)
-> the LM's understanding flow.  Plus the LM-only flows
(``understand_music``, ``create_sample``, ``format_sample``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from acestep_tpu_torch import scoring
from acestep_tpu_torch.constants import TASK_TYPES
from acestep_tpu_torch.lm_pipeline import LMPipeline, LMResult, indices_to_codes
from acestep_tpu_torch.models import codec
from acestep_tpu_torch.pipeline import (
    AceStepEngine, GenerationRequest, GenerationResult, frames_for_duration,
)
from acestep_tpu_torch.training.dataset_builder import audio_to_codes


@dataclasses.dataclass
class GenerationParams:
    """The reference's GenerationParams surface."""

    caption: str = ""
    lyrics: str = ""
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    duration: float = -1.0                 # -1: let the LM decide
    language: str = ""
    task_type: str = "text2music"
    instruction: str = ""
    track_name: Optional[str] = None                   # extract / lego target
    complete_track_classes: Optional[Sequence[str]] = None
    # LM control
    thinking: bool = True
    use_cot_metas: bool = True
    use_cot_caption: bool = True
    use_cot_language: bool = True
    lm_temperature: float = 0.85
    # per-phase overrides; None = lm_temperature
    lm_metadata_temperature: Optional[float] = None
    lm_codes_temperature: Optional[float] = None
    lm_top_p: float = 0.95
    lm_top_k: int = 0
    lm_cfg_scale: float = 1.0
    lm_negative_prompt: str = "NO USER INPUT"
    lm_num_candidates: int = 1             # > 1: PMI-ranked candidate selection
    # phase-1 CoT under the metadata FSM: on by default, as in the reference
    lm_constrained_cot: bool = True
    # DiT control
    inference_steps: int = 8
    shift: float = 3.0
    timesteps: Optional[Sequence[float]] = None
    infer_method: str = "ode"
    audio_cover_strength: float = 1.0
    repaint_start: float = 0.0
    repaint_end: float = -1.0
    # conditioning inputs (pre-tokenized)
    style_token_ids: Optional[np.ndarray] = None
    style_mask: Optional[np.ndarray] = None
    lyric_token_ids: Optional[np.ndarray] = None
    lyric_mask: Optional[np.ndarray] = None
    refer_latents: Optional[np.ndarray] = None
    src_latents: Optional[np.ndarray] = None


@dataclasses.dataclass
class GenerationConfig:
    batch_size: int = 1
    seeds: Optional[List[int]] = None
    audio_format: str = "wav"
    use_random_seed: bool = True
    lm_batch_chunk_size: int = 4


@dataclasses.dataclass
class MusicResult:
    sample_rate: int
    metadata: Dict[str, Any]
    lm_result: Optional[LMResult]
    dit_result: GenerationResult
    time_costs: Dict[str, float]
    seeds: List[int]

    @property
    def audio(self) -> np.ndarray:
        """Float32 audio (the DiT result's int16 over its scale)."""
        return self.dit_result.audio

    def pcm16(self) -> np.ndarray:
        """WAV-ready int16 PCM [B, L, C]."""
        return self.dit_result.audio_i16


def generate_music(engine: AceStepEngine, lm: Optional[LMPipeline], params: GenerationParams,
                   config: Optional[GenerationConfig] = None,
                   codec_params: Optional[Dict[str, Any]] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   sde_noise: Optional[torch.Tensor] = None) -> MusicResult:
    """The full request (inference.py:103-228): LM phase -> metadata merge ->
    DiT phase -> decode.  ``codec_params`` (``models/codec``) turn a
    text2music request's LM codes into src latents of a cover.  ``noise`` /
    ``sde_noise`` go to ``AceStepEngine.generate`` (tests pass the JAX
    package's draws)."""
    config = config or GenerationConfig()
    time_costs: Dict[str, float] = {}
    t0 = time.perf_counter()

    metadata: Dict[str, Any] = {}
    lm_result: Optional[LMResult] = None
    user_metadata: Dict[str, Any] = {}
    if params.bpm:
        user_metadata["bpm"] = params.bpm
    if params.keyscale:
        user_metadata["keyscale"] = params.keyscale
    if params.timesignature:
        user_metadata["timesignature"] = params.timesignature
    if params.duration and params.duration > 0:
        user_metadata["duration"] = int(params.duration)
    if params.language:
        user_metadata["language"] = params.language

    if lm is not None and (params.thinking or params.use_cot_metas):
        lm_result = lm.generate_with_stop_condition(
            params.caption, params.lyrics,
            target_duration_s=params.duration if params.duration > 0 else None,
            temperature=params.lm_temperature,
            metadata_temperature=params.lm_metadata_temperature,
            codes_temperature=params.lm_codes_temperature,
            top_p=params.lm_top_p, top_k=params.lm_top_k, cfg_scale=params.lm_cfg_scale,
            negative_prompt=params.lm_negative_prompt, user_metadata=user_metadata,
            thinking=params.thinking, seed=(config.seeds or [0])[0],
            batch_size=max(1, params.lm_num_candidates),
            chunk_size=config.lm_batch_chunk_size,
            constrained_cot=params.lm_constrained_cot)
        metadata = dict(lm_result.metadata)
        time_costs.update(lm_result.time_costs)

        # test-time scaling: PMI-rank the candidate code sequences, keep the best
        if params.lm_num_candidates > 1 and lm_result.candidates \
                and len(lm_result.candidates) > 1:
            t_rank = time.perf_counter()
            cond_ids = lm.tok.encode(f"# Caption\n{params.caption}\n\n# Lyric\n{params.lyrics}\n")
            base = lm.tok.audio_code_base_id
            cand_tok = [list(np.asarray(c) + base) for c in lm_result.candidates]
            order = scoring.rank_candidates(lm.params, lm.cfg, cond_ids, cand_tok)
            best = lm_result.candidates[order[0]]
            lm_result.code_indices = np.asarray(best, np.int32)
            lm_result.audio_codes = indices_to_codes(best)
            time_costs["lm_ranking_time_cost"] = time.perf_counter() - t_rank
    else:
        metadata = dict(user_metadata)

    # metadata merge: the user's duration wins
    duration = params.duration if params.duration > 0 else float(metadata.get("duration", 30))
    req = GenerationRequest(
        duration_s=duration, style_token_ids=params.style_token_ids,
        style_mask=params.style_mask, lyric_token_ids=params.lyric_token_ids,
        lyric_mask=params.lyric_mask, refer_latents=params.refer_latents,
        task=params.task_type if params.task_type in TASK_TYPES else "text2music",
        src_latents=params.src_latents, track_name=params.track_name,
        complete_track_classes=params.complete_track_classes,
        repaint_start_s=params.repaint_start, repaint_end_s=params.repaint_end,
        audio_cover_strength=params.audio_cover_strength, seeds=config.seeds,
        shift=params.shift, timesteps=params.timesteps, infer_method=params.infer_method,
        batch_size=config.batch_size)
    # code hints: the LM codes -> 25 Hz latent hints, the source of a cover
    if (lm_result is not None and codec_params is not None
            and lm_result.code_indices.size > 0 and req.src_latents is None
            and params.task_type == "text2music"):
        hints = codec.codes_to_latents(codec_params, lm_result.code_indices,
                                       frames_for_duration(duration))
        req.src_latents = hints.float().cpu().numpy()
        req.task = "cover"
    dit_result = engine.generate(req, noise=noise, sde_noise=sde_noise)
    time_costs.update(dit_result.time_costs)
    time_costs["total_time_cost"] = time.perf_counter() - t0
    return MusicResult(sample_rate=dit_result.sample_rate, metadata=metadata,
                       lm_result=lm_result, dit_result=dit_result, time_costs=time_costs,
                       seeds=dit_result.seeds)


def understand_music(lm: LMPipeline, audio_codes: str, **kw) -> Dict[str, Any]:
    """Audio codes -> metadata and lyrics."""
    return lm.understand_audio_from_codes(audio_codes, **kw)


def understand_audio(engine: AceStepEngine, lm: LMPipeline, codec_params: Dict[str, Any],
                     audio: np.ndarray, **kw) -> Dict[str, Any]:
    """A waveform [L, C] -> metadata and lyrics: VAE encode -> 5 Hz codes (the
    codec's tokenize) -> the LM's understanding flow (inference.py:236-249)."""
    codes = audio_to_codes(engine, codec_params, np.asarray(audio, np.float32))
    return lm.understand_audio_from_codes(codes, **kw)


def create_sample(lm: LMPipeline, query: str, **kw) -> Dict[str, Any]:
    """A free-text query -> a structured sample."""
    return lm.create_sample_from_query(query, **kw)


def format_sample(lm: LMPipeline, text: str, **kw) -> Dict[str, Any]:
    """Messy input -> a formatted sample."""
    return lm.format_sample_from_input(text, **kw)
