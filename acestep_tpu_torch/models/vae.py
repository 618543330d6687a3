"""Oobleck VAE (48 kHz stereo) in PyTorch: port of the JAX package's
models/vae.py decode / encode / posterior draw / tiled int16 decode.

Precision: everything computes in float32 (the Snake/ConvTranspose chain
degrades audibly in reduced precision).  On the card a float32 convolution
would otherwise run through cuDNN in TF32, which keeps about three decimal
digits, so importing this module sets
``torch.backends.cudnn.allow_tf32 = False`` and
``torch.backends.cuda.matmul.allow_tf32 = False``.

Layouts are the JAX package's: activations ``[B, L, C]``; conv kernels
``[k, C_in, C_out]`` (torch Conv1d ``[out, in, k]`` -> transpose(2, 1, 0));
transposed-conv kernels spatially reversed ``[k, C_in, C_out]`` (torch
ConvTranspose1d ``[in, out, k]`` -> transpose(2, 0, 1)[::-1]).  Weight-norm is
folded at conversion time.

Res units dispatch as in the JAX decoder (vae.py:227-275): a 128-channel block
runs its three units as one fused trio kernel, a 256-channel block unit by unit
through the fused unit kernel (``ops.cuda.vae_resunit``); wider blocks and the
transposed convs are plain torch convs.  The encoder dispatches the same way:
at full width its blocks 0-1 (128 channels, at L and L / 2) take the trio and
block 2 (256 channels, at L / 8) the unit.

The tiled decode (vae.py:484-700) groups its overlap-discard windows by (size,
trims), stacks each group's (window, item) rows window-major and decodes at
most ``max_window_batch`` rows a call; ``fused_decode_windows_int16`` decodes
one segment of a segmented decode at its own scale.

``encode``, ``encode_and_sample``, ``decode`` and ``tiled_encode`` are
differentiable, as the JAX functions are: with grad on and an input or
parameter that requires it, autograd runs through the convs and through the
res kernels' ``KernelGrad`` (ops/cuda/vae_resunit.py).  The engine's callers
run them under ``torch.no_grad()`` on parameters that require no grad, so
serving builds no graph; the int16 decodes are never differentiable.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import VAEConfig
from acestep_tpu_torch.ops.cuda import vae_resunit as _vru

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """torch.nn.Conv1d semantics on [B, L, C] input; w is [k, in, out]."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride,
                 padding=padding, dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d semantics; w is spatially reversed [k, in, out].
    out_len = (L-1)*stride - 2*padding + k."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), b,
                           stride=stride, padding=padding)
    return y.transpose(1, 2)


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
          logscale: bool = True) -> torch.Tensor:
    """Snake activation x + sin^2(a*x)/b, f32 compute."""
    xf = x.float()
    a = torch.exp(alpha.float()) if logscale else alpha.float()
    b = torch.exp(beta.float()) if logscale else beta.float()
    return (xf + (1.0 / (b + 1e-9)) * torch.square(torch.sin(a * xf))).to(x.dtype)


def _fusable(u: Params) -> bool:
    w1, w2 = u["conv1"]["w"], u["conv2"]["w"]
    return w1.shape[0] == 7 and w2.shape[0] == 1 and w1.shape[1] == w1.shape[2]


def _res_unit(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    if x.shape[-1] in _vru.UNIT_CHANNELS and _fusable(p):
        return _vru.fused_res_unit(p, x, dilation)
    pad = ((7 - 1) * dilation) // 2
    y = conv1d(snake(x, **p["snake1"]), p["conv1"]["w"], p["conv1"].get("b"),
               padding=pad, dilation=dilation)
    y = conv1d(snake(y, **p["snake2"]), p["conv2"]["w"], p["conv2"].get("b"))
    return x + y


def _res_trio(blk: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's res-unit chain (dilations 1, 3, 9): one fused trio kernel at
    128 channels, else unit by unit."""
    units = (blk["res1"], blk["res2"], blk["res3"])
    if x.shape[-1] in _vru.TRIO_CHANNELS and all(_fusable(u) for u in units):
        return _vru.fused_res_trio(units, x)
    for u, d in zip(units, _vru.TRIO_D):
        x = _res_unit(u, x, d)
    return x


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def _encoder(params: Params, cfg: VAEConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, L, 2] -> the encoder's [B, L//hop, 2 * 64] (mean | scale).
    Block i runs its res units at L / prod(ratios[:i]): the 128-channel
    blocks through the trio kernel, the 256-channel one unit by unit."""
    p = params["encoder"]
    x = audio.to(p["conv1"]["w"].dtype)
    x = conv1d(x, p["conv1"]["w"], p["conv1"].get("b"), padding=3)
    for blk, s in zip(p["blocks"], cfg.downsampling_ratios):
        x = _res_trio(blk, x)
        x = snake(x, **blk["snake1"])
        x = conv1d(x, blk["conv1"]["w"], blk["conv1"].get("b"), stride=s,
                   padding=math.ceil(s / 2))
    x = snake(x, **p["snake1"])
    return conv1d(x, p["conv2"]["w"], p["conv2"].get("b"), padding=1)


def encode(params: Params, cfg: VAEConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, L, 2] -> posterior MEAN latents [B, L//hop, 64]."""
    x = _encoder(params, cfg, audio)
    return x[..., : x.shape[-1] // 2].float()


def encode_and_sample(params: Params, cfg: VAEConfig, audio: torch.Tensor,
                      draw: torch.Tensor) -> torch.Tensor:
    """A draw z ~ posterior: ``mean + std * draw`` with the softplus std
    ``where(scale > 20, scale, log1p(exp(min(scale, 20)))) + 1e-4``
    (vae.py:295-311).  ``draw`` [B, L//hop, 64] is the standard normal draw,
    given by the caller (torch cannot reproduce ``jax.random``)."""
    x = _encoder(params, cfg, audio.float())
    mean, scale = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    std = torch.where(scale > 20.0, scale,
                      torch.log1p(torch.exp(torch.clamp(scale, max=20.0)))) + 1e-4
    return mean + std * draw.to(mean.device, torch.float32)


def decode(params: Params, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, T, 64] -> audio [B, T*hop, 2]."""
    p = params["decoder"]
    x = latents.to(p["conv1"]["w"].dtype)
    x = conv1d(x, p["conv1"]["w"], p["conv1"].get("b"), padding=3)
    for blk, s in zip(p["blocks"], cfg.upsampling_ratios):
        x = snake(x, **blk["snake1"])
        x = conv_transpose1d(x, blk["conv_t1"]["w"], blk["conv_t1"].get("b"),
                             stride=s, padding=math.ceil(s / 2))
        x = _res_trio(blk, x)
    x = snake(x, **p["snake1"])
    return conv1d(x, p["conv2"]["w"], None, padding=3)


# ---------------------------------------------------------------------------
# tiled decode / encode (overlap-discard windows)
# ---------------------------------------------------------------------------

def _window_plan(t: int, chunk_frames: int, overlap_frames: Optional[int]):
    """Overlap-discard window plan: (core_start, core_end, win_start, win_end)."""
    if overlap_frames is None:
        overlap_frames = min(64, max(1, chunk_frames // 4))
    if overlap_frames * 2 >= chunk_frames:
        overlap_frames = max(0, chunk_frames // 2 - 1)
    stride = chunk_frames - 2 * overlap_frames
    if stride <= 0:
        overlap_frames, stride = 0, chunk_frames
    windows = []
    for core_start in range(0, t, stride):
        core_end = min(core_start + stride, t)
        win_start = max(0, core_start - overlap_frames)
        win_end = min(t, core_end + overlap_frames)
        windows.append((core_start, core_end, win_start, win_end))
    return windows


def _decode_rows(params, cfg, latents, max_rows: int) -> torch.Tensor:
    """decode() of a stack of rows, at most ``max_rows`` rows a call."""
    wb = max(1, min(max_rows, latents.shape[0]))
    parts = [decode(params, cfg, latents[i:i + wb]) for i in range(0, latents.shape[0], wb)]
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def _decode_window_groups(params, cfg, latents, windows, max_window_batch: int):
    """Decode and trim every window of ``latents [B, T, 64]``; returns the
    pieces in window order, each [B, L_w, C] (vae.py:484-562).

    Windows are grouped by (size, head trim, tail trim); a group's (window,
    item) rows are stacked window-major, ``[Nw * B, size, 64]``, decoded at
    most ``max_window_batch`` rows a call (a merged batch is bounded like a
    long song's window stack), trimmed, and split back per window."""
    b = latents.shape[0]
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for idx, (cs, ce, ws, we) in enumerate(windows):
        groups.setdefault((we - ws, cs - ws, we - ce), []).append(idx)
    decoded = {}
    for (size, tf0, tf1), idxs in groups.items():
        stacked = torch.cat([latents[:, windows[i][2]:windows[i][3]] for i in idxs], dim=0)
        audio = _decode_rows(params, cfg, stacked, max_window_batch)
        ups = audio.shape[1] / size
        t0, t1 = int(round(tf0 * ups)), int(round(tf1 * ups))
        trimmed = audio[:, t0:audio.shape[1] - t1]
        for j, i in enumerate(idxs):
            decoded[i] = trimmed[j * b:(j + 1) * b]
    return [decoded[i] for i in range(len(windows))]


def _to_int16(pieces: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate along time, then quantize at the WAV output scale
    ``32767 * min(1, 0.99 / peak)``: (i16 flat [B*L*C] in C order, scale [])."""
    full = (torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]).float()
    peak = full.abs().amax()
    one = torch.ones((), dtype=torch.float32, device=full.device)
    # a true division, as XLA's (a scalar over a tensor is a reciprocal times
    # the scalar in torch: one f32 step off)
    scale = 32767.0 * torch.where(peak > 0.99, (0.99 * one) / torch.clamp(peak, min=1e-12),
                                  one)
    i16 = torch.clamp(torch.round(full * scale), -32768.0, 32767.0).to(torch.int16)
    return i16.reshape(-1), scale


@torch.no_grad()
def fused_decode_windows_int16(
    params: Params, cfg: VAEConfig, latents: torch.Tensor,
    windows: Sequence[Tuple[int, int, int, int]], max_window_batch: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One segment of a segmented tiled decode: the (segment-relative) windows
    of ``latents [1, T_seg, 64]`` decoded, trimmed, concatenated and quantized
    at the segment's own peak scale -> (i16 flat, scale []).  The caller
    reconciles the segments to the lowest scale."""
    return _to_int16(_decode_window_groups(params, cfg, latents, list(windows),
                                           max_window_batch))


@torch.no_grad()
def fused_tiled_decode_int16(
    params: Params, cfg: VAEConfig, latents: torch.Tensor,
    chunk_frames: int = 512, overlap_frames: Optional[int] = None,
    max_window_batch: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled decode, overlap trim, concat, global peak and int16 quantization:
    returns (audio_i16 flat [B*L*C] in C order, scale []) with
    ``scale = 32767 * min(1, 0.99 / peak)`` (the WAV output scale).  At most
    ``max_window_batch`` (item, window) rows are decoded a call."""
    if chunk_frames >= latents.shape[1]:
        return _to_int16([_decode_rows(params, cfg, latents, max_window_batch)])
    windows = _window_plan(latents.shape[1], chunk_frames, overlap_frames)
    return _to_int16(_decode_window_groups(params, cfg, latents, windows, max_window_batch))


def tiled_encode(params: Params, cfg: VAEConfig, audio: torch.Tensor,
                 chunk_frames: int = 64, overlap_frames: int = 16) -> torch.Tensor:
    """Chunked encode (latent-frame-aligned windows, overlap-discard)."""
    hop = cfg.hop_length
    t = audio.shape[1] // hop
    if chunk_frames <= 0 or chunk_frames >= t:
        return encode(params, cfg, audio[:, : t * hop])
    if overlap_frames * 2 >= chunk_frames:
        overlap_frames = max(0, chunk_frames // 2 - 1)
    stride = chunk_frames - 2 * overlap_frames
    if stride <= 0:
        overlap_frames, stride = 0, chunk_frames
    pieces = []
    for core_start in range(0, t, stride):
        core_end = min(core_start + stride, t)
        win_start = max(0, core_start - overlap_frames)
        win_end = min(t, core_end + overlap_frames)
        lat = encode(params, cfg, audio[:, win_start * hop:win_end * hop])
        pieces.append(lat[:, core_start - win_start: lat.shape[1] - (win_end - core_end)])
    return torch.cat(pieces, dim=1)


def silence_latents(params: Params, cfg: VAEConfig, n_frames: int,
                    chunk_frames: int = 64, device=None) -> torch.Tensor:
    """VAE-encode silence: the src-latent context of text2music."""
    if device is None:
        device = params["encoder"]["conv1"]["w"].device
    audio = torch.zeros((1, n_frames * cfg.hop_length, cfg.audio_channels),
                        dtype=torch.float32, device=device)
    return tiled_encode(params, cfg, audio, chunk_frames=chunk_frames, overlap_frames=0)
