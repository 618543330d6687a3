"""Memory-scalable self-attention of the DiT and its encoders: port of the JAX
package's ops/blocked_attention.py (plain XLA there, plain torch here).

  * :func:`banded_attention` for ``sliding_attention`` layers: with blocks of
    S = window tokens, query block i attends only key blocks {i-1, i, i+1}
    (the band |i - j| <= window lies inside that neighbourhood), so scores are
    O(T * 3S) instead of O(T^2).
  * :func:`flash_attention` for ``full_attention`` layers: online softmax over
    key blocks of ``block_k`` tokens (running max, normaliser and weighted
    accumulator in f32); scores are O(T * block_k).

Both are GQA-aware (queries [B, Hq, T, D] against keys / values
[B, Hkv, T, D]) and mask with the same finite NEG_INF as dense attention, so a
fully masked row averages and never gives NaN.  Their rounding points are the
JAX functions': banded softmaxes in f32 and rounds the probabilities to the
query dtype before P.V, as dense ``ops.nn.attention`` does; flash rounds the
UNNORMALISED block probabilities to the query dtype before P.V and divides by
the f32 normaliser at the end, so it is a different function from dense
attention by that rounding.  Matmuls run in f32 on the (exactly upcast) bf16
operands.

The DiT takes them from :data:`BLOCKED_ATTN_MIN` patch tokens on
(:func:`use_blocked_attention`; the JAX package's default of its
``ACESTEP_TPU_BLOCKED_ATTN_MIN``); below it, dense masked attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from acestep_tpu_torch.ops.nn import NEG_INF

BLOCKED_ATTN_MIN = 1536          # patch tokens (blocked_attention.py:210)
FLASH_BLOCK_K = 1024


def use_blocked_attention(seq_len: int) -> bool:
    """True when the banded / flash path replaces dense masked attention."""
    return seq_len >= BLOCKED_ATTN_MIN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_len(x: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    pad = target - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def _key_valid(b: int, t: int, t2: int, kv_valid: Optional[torch.Tensor], device):
    """[B, t2] bool: padding past ``t`` and invalid keys off."""
    valid = (torch.arange(t2, device=device) < t)[None].expand(b, t2)
    if kv_valid is not None:
        valid = valid & _pad_len(kv_valid.bool(), 1, t2)
    return valid


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                     kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional sliding-window attention (band |i - j| <= window) without
    T x T scores; equal to dense attention under the sliding mask."""
    b, hq, t, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    dtype = q.dtype
    scale = 1.0 / math.sqrt(d)
    s = max(int(window), 1)
    nb = _cdiv(t, s)
    t2 = nb * s

    q, k, v = (_pad_len(x, 2, t2) for x in (q, k, v))
    valid = _key_valid(b, t, t2, kv_valid, q.device)

    # window-sized blocks, one zero block each side, then each block's
    # 3-neighbourhood of keys
    qb = q.reshape(b, hkv, rep, nb, s, d).float()
    kb_ext = F.pad(k.reshape(b, hkv, nb, s, d), (0, 0, 0, 0, 1, 1))
    vb_ext = F.pad(v.reshape(b, hkv, nb, s, d), (0, 0, 0, 0, 1, 1))
    validb_ext = F.pad(valid.reshape(b, nb, s), (0, 0, 1, 1))
    k3 = torch.cat([kb_ext[:, :, o:o + nb] for o in range(3)], dim=3).float()
    v3 = torch.cat([vb_ext[:, :, o:o + nb] for o in range(3)], dim=3).float()
    valid3 = torch.cat([validb_ext[:, o:o + nb] for o in range(3)], dim=2)

    # scores [B, Hkv, rep, nb, S, 3S]
    scores = torch.matmul(qb, k3[:, :, None].transpose(-1, -2)).mul_(scale)
    # key column c is at relative position c - S - r from query row r
    r = torch.arange(s, device=q.device)[:, None]
    c = torch.arange(3 * s, device=q.device)[None, :]
    band = (c - s - r).abs() <= window                                    # [S, 3S]
    bias = torch.where(band[None, None] & valid3[:, :, None, :],
                       torch.zeros((), device=q.device),
                       torch.full((), NEG_INF, device=q.device))          # [B, nb, S, 3S]
    scores = scores.add_(bias[:, None, None])
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(probs.float(), v3[:, :, None])
    return out.reshape(b, hq, t2, d)[:, :, :t].to(dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Full bidirectional attention by online softmax over key blocks, with the
    JAX function's rounding of the unnormalised block probabilities."""
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    dtype = q.dtype
    scale = 1.0 / math.sqrt(d)
    tk = k.shape[2]
    bk = min(block_k, max(tk, 1))
    nb = _cdiv(tk, bk)
    t2 = nb * bk

    k, v = _pad_len(k, 2, t2), _pad_len(v, 2, t2)
    valid = _key_valid(b, tk, t2, kv_valid, q.device)
    bias = torch.where(valid, torch.zeros((), device=q.device),
                       torch.full((), NEG_INF, device=q.device))          # [B, t2] f32

    qg = q.reshape(b, hkv, rep, tq, d).float()
    m = torch.full((b, hkv, rep, tq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, rep, tq, 1), device=q.device)
    acc = torch.zeros((b, hkv, rep, tq, d), device=q.device)
    for i in range(nb):
        blk = slice(i * bk, (i + 1) * bk)
        s = torch.matmul(qg, k[:, :, None, blk].float().transpose(-1, -2)).mul_(scale)
        s = s.add_(bias[:, None, None, None, blk])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # in place unless autograd needs s (amax's backward reads it)
        p = torch.exp(s - m_new if s.requires_grad else s.sub_(m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(dtype).float(), v[:, :, None, blk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, tq, d).to(dtype)
