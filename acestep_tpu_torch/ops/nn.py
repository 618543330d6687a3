"""Core NN primitives shared by the DiT / Qwen / encoder stacks (port of the JAX
package's ops/nn.py, same numerics).

  * RMSNorm computes in f32 and rounds once to the input dtype.
  * RoPE is NEOX rotate-half with ``emb = concat(freqs, freqs)``.
  * GQA head h reads kv head h // n_rep.
  * Attention scores are scaled by 1/sqrt(head_dim), masked additively and
    softmaxed in f32; probabilities are rounded to the query dtype before the
    value product, which accumulates in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # finite big-negative: keeps fully-masked padding rows NaN-free


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, base: float = 1e6,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [L] -> (cos, sin) each [L, head_dim].  Device ops only (no
    tensor made from host data), so a decode step never waits on the host."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(float(base), exps)
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: [..., L, head_dim]; cos/sin: [L, head_dim]."""
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def make_attention_mask(q_len: int, k_len: int, kv_valid: Optional[torch.Tensor] = None,
                        causal: bool = False, sliding_window: Optional[int] = None,
                        device=None) -> Optional[torch.Tensor]:
    """Additive f32 mask [B or 1, 1, q_len, k_len]; None if unmasked."""
    if kv_valid is None and not causal and sliding_window is None:
        return None
    if kv_valid is not None:
        device = kv_valid.device
    qi = torch.arange(q_len, device=device)[:, None]
    ki = torch.arange(k_len, device=device)[None, :]
    allow = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        allow = allow & (ki <= qi)
        if sliding_window is not None:
            allow = allow & (qi - ki <= sliding_window)
    elif sliding_window is not None:
        allow = allow & ((qi - ki).abs() <= sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    mask = torch.where(allow, zero, neg)[None, None]
    if kv_valid is not None:
        pad = torch.where(kv_valid.bool(), zero, neg)
        mask = mask + pad[:, None, None, :]
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA: q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D]."""
    b, hq, lq, d = q.shape
    hkv = k.shape[1]
    n_rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, n_rep, lq, d).float()
    scores = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()[:, :, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), v.float()[:, :, None])
    return out.reshape(b, hq, lq, d).to(q.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """t [B] -> [B, dim] = concat(cos(args), sin(args))."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (t.float() * scale)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
