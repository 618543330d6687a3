"""Per-phase roofline accounting: algorithmic bytes and FLOPs against the
card's peaks.  The port's copy of the JAX package's roofline counts (the same
byte and FLOP counts for the same trees and configs), with the peaks of the
card the port runs on.

Byte counts are ALGORITHMIC lower bounds (each weight byte streamed once per
step, each activation written and read once across fusion boundaries); a
measured time within ~70 % of a bound means the phase is at that bound's
speed of light for this algorithm.  A bound is the larger of bytes over the
memory rate and operations over the peak rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.memory_planner import tree_bytes
from acestep_tpu_torch.weights import flatten

# Published dense peaks of the SXM part at its 700 W limit (NVIDIA's data
# sheet; PERF.md's kernel table uses the same): bf16 and int8 on the tensor
# cores, f32 on the CUDA cores, HBM3.  A card set below 700 W runs slower.
CHIP_PEAKS = {
    "h100": {"bf16_flops": 989e12, "int8_ops": 1979e12, "f32_flops": 67e12,
             "hbm_bps": 3.35e12},
}
_NAMES = (("h100", "H100"),)


def detect_chip() -> str:
    """The ``CHIP_PEAKS`` key of CUDA device 0, from its name; raises on a card
    the table does not hold, or without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the roofline peaks are the card's")
    name = torch.cuda.get_device_name(0)
    for key, probe in _NAMES:
        if probe in name:
            return key
    raise RuntimeError(f"no peaks for {name!r} (known: {', '.join(CHIP_PEAKS)})")


def bound_s(bytes_: float, flops: float, chip: str, peak: str = "bf16_flops") -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations"): the larger of ``bytes_`` over
    the memory rate and ``flops`` over the ``peak`` rate of ``chip``."""
    peaks = CHIP_PEAKS[chip]
    t_bytes, t_ops = bytes_ / peaks["hbm_bps"], flops / peaks[peak]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# DiT Euler step
# ---------------------------------------------------------------------------

# top-level entries a request runs once, before its Euler steps
_PER_REQUEST = ("text_projector", "condition_embedder", "lyric_", "timbre_")
# the cross-attention leaves cross_kv reads once a request
_CROSS_KV = ("k_proj", "v_proj", "k_norm")


def dit_step_weight_bytes(params: Dict[str, Any]) -> int:
    """Weight bytes ONE DiT forward streams, each read once: the decoder's
    leaves (stacked or per-layer), without what a request computes once, before
    its steps: the text projector, the lyric and timbre encoders (``lyric_*`` /
    ``timbre_*``), the condition embedder and the cross-attention's K/V
    projections (whose FLOPs ``dit_step_flops`` leaves out too).  The JAX
    count skips only ``text_projector`` of these (its skip list names
    ``lyric_encoder`` / ``timbre_encoder``, which its tree does not have), so
    it is larger by the others' bytes."""
    total = 0
    for name, leaf in flatten(params).items():
        parts = name.split("/")
        if parts[0].startswith(_PER_REQUEST):
            continue
        if "cross_attn" in parts and parts[parts.index("cross_attn") + 1] in _CROSS_KV:
            continue
        total += tree_bytes(leaf)
    return total


def dit_step_flops(cfg: DiTConfig, frames: int, cond_tokens: int, batch: int = 1) -> int:
    """Matmul + attention FLOPs of one DiT forward (2*K*N*T per matmul); the
    cross-attention K/V projections are excluded (computed once a request)."""
    t = frames // cfg.patch_size
    h = cfg.hidden_size
    qdim = cfg.num_attention_heads * cfg.head_dim
    kvdim = cfg.num_key_value_heads * cfg.head_dim
    inter = cfg.intermediate_size
    per_layer = 0
    # self-attn projections: q, k, v, o
    per_layer += 2 * t * h * (qdim + 2 * kvdim) + 2 * t * qdim * h
    # cross-attn: q + o only (kv cached)
    per_layer += 2 * t * h * qdim + 2 * t * qdim * h
    # mlp
    per_layer += 2 * t * h * (2 * inter) + 2 * t * inter * h
    total = 0
    for lt in cfg.layer_types:
        t_eff = min(t, cfg.sliding_window) if lt == "sliding_attention" else t
        # scores + value-weighted sum, q heads against t_eff keys
        attn = 4 * t * t_eff * qdim
        cross = 4 * t * cond_tokens * qdim
        total += per_layer + attn + cross
    # patchify / unpatchify
    total += 2 * t * (cfg.in_channels * cfg.patch_size) * h
    total += 2 * t * h * (cfg.audio_acoustic_hidden_dim * cfg.patch_size)
    return batch * total


# ---------------------------------------------------------------------------
# VAE decode
# ---------------------------------------------------------------------------

def _vae_decoder_layers(cfg: VAEConfig, frames: int):
    """(k, cin, cout, l_in, l_out) of every decoder conv at ``frames`` input
    latent frames (models/vae.decode's structure)."""
    ch = cfg.decoder_channels
    cm = (1,) + tuple(cfg.channel_multiples)
    strides = cfg.upsampling_ratios
    length = frames
    yield (7, cfg.decoder_input_channels, ch * cm[-1], length, length)      # conv1
    for i, s in enumerate(strides):
        cin = ch * cm[len(strides) - i]
        cout = ch * cm[len(strides) - i - 1]
        yield (2 * s, cin, cout, length, length * s)                        # conv_t
        length *= s
        for _ in range(3):                                                  # res units
            yield (7, cout, cout, length, length)
            yield (1, cout, cout, length, length)
    yield (7, ch, cfg.audio_channels, length, length)                       # conv2


def vae_decode_flops(cfg: VAEConfig, frames: int, batch: int = 1) -> int:
    """2 x conv MACs of one decode of ``frames`` latent frames (a transposed
    conv counted per input position, k taps)."""
    total = 0
    for k, cin, cout, l_in, l_out in _vae_decoder_layers(cfg, frames):
        total += 2 * (l_in if l_out > l_in else l_out) * k * cin * cout
    return batch * total


def vae_decode_act_bytes(cfg: VAEConfig, frames: int, batch: int = 1,
                         dtype_bytes: int = 4) -> int:
    """Activation traffic lower bound: each conv reads its input once and
    writes its output once (the weights are negligible beside them)."""
    total = 0
    for _, cin, cout, l_in, l_out in _vae_decoder_layers(cfg, frames):
        total += (l_in * cin + l_out * cout) * dtype_bytes
    return batch * total


# ---------------------------------------------------------------------------
# LM decode
# ---------------------------------------------------------------------------

def lm_decode_bytes(params: Dict[str, Any], cfg: QwenConfig, cache_len: int = 512,
                    batch: int = 1) -> int:
    """Bytes streamed per decode step: every weight once (batch-independent)
    plus the int8 KV cache (and its f32 scales) once per item."""
    w = tree_bytes(params)
    kv = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
          * cache_len * (cfg.head_dim + 4))
    return w + batch * kv


@dataclasses.dataclass
class RooflinePoint:
    phase: str
    time_s: float
    bytes_: int
    flops: int
    chip: str = ""

    def summary(self) -> Dict[str, Any]:
        chip = self.chip or detect_chip()
        peaks = CHIP_PEAKS[chip]
        bps, fps = self.bytes_ / self.time_s, self.flops / self.time_s
        least, by = bound_s(self.bytes_, self.flops, chip)
        return {
            "phase": self.phase,
            "time_ms": round(self.time_s * 1e3, 3),
            "GB_s": round(bps / 1e9, 1),
            "TFLOP_s": round(fps / 1e12, 2),
            "pct_hbm_roof": round(100 * bps / peaks["hbm_bps"], 1),
            "pct_bf16_roof": round(100 * fps / peaks["bf16_flops"], 1),
            "bound_ms": round(least * 1e3, 3),
            "bound_by": by,
            "chip": chip,
        }
