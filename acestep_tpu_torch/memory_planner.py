"""Static device-memory planner: the port's copy of the JAX package's
memory_planner.py (admission control ahead of launch, the reference's VRAM
guard and VAE chunk auto-sizing).

From a static activation-memory model it clamps a request's batch, and picks
the VAE decode chunk and window batch, so that a request fits on the device
before it starts.  The arithmetic and ``SAFETY_MARGIN`` are the JAX
package's.  The JAX ``Plan.dit_qmm_backend`` field is not kept: the port has
one matmul backend, its kernels, and holds no dequantized bf16 copy of the
weights.  Device memory is the card's total memory
(``torch.cuda.get_device_properties``); on the CPU it is the JAX package's
default of 16 GiB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from acestep_tpu_torch.config import DiTConfig, VAEConfig
from acestep_tpu_torch.ops import blocked_attention
from acestep_tpu_torch.quant import QuantTensor

GiB = 1024 ** 3
DEFAULT_DEVICE_BYTES = 16 * GiB
SAFETY_MARGIN = 1.5 * GiB       # allocator scratch and fragmentation headroom


def detect_device_bytes(device=None) -> int:
    """Total memory of the card ``device`` is on; 16 GiB for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return DEFAULT_DEVICE_BYTES


def tree_bytes(params: Any) -> int:
    """Bytes of every tensor of a parameter tree (a QuantTensor counts its fields)."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    if isinstance(params, QuantTensor):
        return params.nbytes
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


def dit_activation_bytes(cfg: DiTConfig, batch: int, frames: int) -> int:
    """Peak activation estimate of one DiT forward at bf16: dense f32 scores
    below the blocked-attention threshold, the banded / flash kernels' O(T *
    block) scores from it on."""
    tp = (frames + cfg.patch_size - 1) // cfg.patch_size
    if tp >= blocked_attention.BLOCKED_ATTN_MIN:
        # banded: scores Tp*3W f32 + k3/v3 copies 2*(Tp*3S*D) bf16 per kv head;
        # flash: scores Tp*block_k f32 + f32 accumulator Tp*D per head
        w3 = 3 * max(cfg.sliding_window, 1)
        flash_blk = 1024
        per_head_scores = 4 * tp * max(w3, flash_blk)
        kv_copies = 2 * 2 * cfg.num_key_value_heads * tp * 3 * cfg.head_dim
        accum = 4 * cfg.num_attention_heads * tp * cfg.head_dim
        scores = batch * (cfg.num_attention_heads * per_head_scores + kv_copies + accum)
    else:
        scores = 4 * batch * cfg.num_attention_heads * tp * tp    # f32 dense
    hidden = 2 * batch * tp * cfg.hidden_size
    mlp = 2 * batch * tp * cfg.intermediate_size
    # ~6 live hidden-sized tensors + 2 mlp-sized + 1 score tensor at peak
    return scores + 6 * hidden + 2 * mlp


def vae_decode_bytes_per_frame(cfg: VAEConfig) -> int:
    """f32 activation bytes per latent frame of decode (full-rate conv stack:
    channels * hop * 4 bytes with ~4 live tensors at the widest layer)."""
    widest = cfg.decoder_channels * max(cfg.channel_multiples)
    return 4 * widest * cfg.hop_length // max(cfg.upsampling_ratios) * 4


@dataclasses.dataclass
class Plan:
    max_batch: int
    vae_chunk_frames: int
    fits: bool
    detail: Dict[str, int]
    vae_window_batch: int = 4


def plan_request(dit_cfg: DiTConfig, vae_cfg: VAEConfig, param_bytes: int, batch: int,
                 frames: int, device_bytes: Optional[int] = None) -> Plan:
    """Clamp batch / VAE chunk / window batch so the request fits (admission
    control).  ``device_bytes`` defaults to :func:`detect_device_bytes`."""
    total = device_bytes if device_bytes is not None else detect_device_bytes()
    budget = total - SAFETY_MARGIN - param_bytes

    b = max(1, batch)
    while b > 1 and dit_activation_bytes(dit_cfg, b, frames) > budget:
        b -= 1
    dit_bytes = dit_activation_bytes(dit_cfg, b, frames)

    vae_budget = budget     # the VAE runs after the diffusion; latents are small
    per_frame = vae_decode_bytes_per_frame(vae_cfg) * b
    # start at the reference's auto chunk (512) and halve under tight budgets
    chunk = 512
    while chunk > 16 and chunk * per_frame > vae_budget:
        chunk //= 2
    # the window batch counts (item, window) pairs, the unit of the windowed
    # decode, so it budgets per-item frame bytes; decoded audio stays resident
    # until assembly
    per_frame_item = vae_decode_bytes_per_frame(vae_cfg)

    def _audio_resident(nb: int) -> int:
        return 2 * 4 * frames * vae_cfg.hop_length * vae_cfg.audio_channels * nb

    wb = 4
    while wb > 1 and wb * chunk * per_frame_item + _audio_resident(b) > vae_budget // 2:
        wb //= 2
    # the resident audio can exceed the VAE budget even at wb = 1 (a merge of
    # several long requests that passed the DiT check): clamp b too
    while b > 1 and chunk * per_frame_item + _audio_resident(b) > vae_budget // 2:
        b -= 1
        dit_bytes = dit_activation_bytes(dit_cfg, b, frames)
    per_frame = per_frame_item * b
    fits = (dit_bytes <= budget and chunk * per_frame <= vae_budget
            and chunk * per_frame_item + _audio_resident(b) <= vae_budget // 2)
    return Plan(
        max_batch=b,
        vae_chunk_frames=chunk,
        vae_window_batch=wb,
        fits=fits,
        detail={
            "hbm_bytes": total,
            "param_bytes": param_bytes,
            "dit_activation_bytes": dit_bytes,
            "vae_bytes_per_frame": per_frame,
            "budget": int(budget),
        },
    )
