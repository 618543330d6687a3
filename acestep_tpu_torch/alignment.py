"""Lyric-to-audio alignment: a cross-attention probe, DTW, LRC timestamps and a
score.  Port of the JAX package's alignment.py.

The probe re-noises the generated latents once (``x_t = t * eps + (1 - t) *
x0``, t = 0.3) and runs the DiT decoder layers once, collecting every layer's
cross-attention probabilities, averaged over heads and layers.  DTW turns the
(audio patch x lyric token) map into a monotonic path, which gives each token
its first time and the map a quality score.  The DTW, timestamp, score and
LRC functions are numpy, copied from the JAX package.

The probe runs through the port's ``models/dit`` functions on the engine's
fused, stacked parameters, so its linears take the dequant-matmul kernels on
the card.  Its numerics follow the JAX probe: the cross-attention scores are
f32 products of the bf16 q and k (f32 matmul, no TF32), divided by
``sqrt(head_dim)`` and softmaxed in f32.  Its self-attention is dense at
every length, the sliding mask on sliding layers, as the JAX probe's is; the
blocked path of ``dit.forward`` from 1536 tokens is not taken, so at 600 s
each layer makes a [16, 7552, 7552] f32 score tensor (3.6 GB).

On a meshed engine (``group``: the tp group) each rank probes its own heads
on its shards, with the row-parallel sums of the decoder in between, and the
map is the mean over layers and the global heads: each rank's sum over its
heads, summed over the group in rank order in f32, divided once.  The batch
is whole on every rank, so every rank returns the same map.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.models.stacking import iter_layers
from acestep_tpu_torch.ops import attention, linear, make_attention_mask, rms_norm, rope_cos_sin
from acestep_tpu_torch.parallel.distributed import all_reduce

T_RENOISE = 0.3


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32 (no TF32) inside the block, the setting
    restored after it."""
    saved = torch.get_float32_matmul_precision()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32


# ---------------------------------------------------------------------------
# cross-attention map extraction (one re-noised forward)
# ---------------------------------------------------------------------------

def _cross_attn_probs(p, cfg: DiTConfig, x, kv, mask):
    """One cross-attention layer's probabilities [B, H, Tq, Lc] (f32)."""
    b, l, _ = x.shape
    hd, nh = cfg.head_dim, cfg.num_attention_heads
    q = linear(x, p["q_proj"]["kernel"]).reshape(b, l, nh, hd)
    q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps).transpose(1, 2)
    k, v = kv
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, nh // hkv, l, hd)
    with full_f32_matmul():
        scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    # a true division, as the JAX probe's (on the card a division by a Python
    # number would be a multiplication by its reciprocal)
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32, device=scores.device)
    if mask is not None:
        scores = scores + mask.float()[:, :, None]
    probs = torch.softmax(scores, dim=-1)
    return probs.reshape(b, nh, l, k.shape[2])


def default_eps(latents: torch.Tensor) -> torch.Tensor:
    """The probe's noise: a standard normal draw of ``latents``' shape from a
    ``torch.Generator`` seeded 0 on their device (the JAX probe draws with
    ``jax.random.key(0)``, which torch cannot reproduce)."""
    g = torch.Generator(device=latents.device).manual_seed(0)
    return torch.randn(latents.shape, generator=g, device=latents.device)


@torch.no_grad()
def cross_attention_maps(params: Dict[str, Any], cfg: DiTConfig, latents: torch.Tensor,
                         context_latents: torch.Tensor, encoder_hidden_states: torch.Tensor,
                         encoder_attn_mask: Optional[torch.Tensor] = None,
                         t_renoise: float = T_RENOISE,
                         eps: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """Cross-attention map averaged over heads and layers -> [B, Tp, Lc] f32.

    ``latents`` [B, T, 64] are the clean latents, ``context_latents`` and
    ``encoder_hidden_states`` [B, Lc, H] the request's; ``eps`` (the latents'
    shape) defaults to :func:`default_eps`.  ``params`` may be unstacked or
    the engine's stacked (and fused) tree.  ``group``: the tp group, with
    ``params`` and ``cfg`` this rank's shards and local heads (module
    docstring)."""
    params = dit.stack_params(params)
    b, t_len, _ = latents.shape
    patch = cfg.patch_size
    dtype = torch.bfloat16
    dev = latents.device

    eps = default_eps(latents) if eps is None else eps.to(dev, torch.float32)
    xt = t_renoise * eps + (1.0 - t_renoise) * latents.float()

    t_b = torch.full((b,), t_renoise, dtype=torch.float32, device=dev)
    _, timestep_proj = dit.compute_timestep_conditioning(params, cfg, t_b, t_b, dtype)

    x = torch.cat([context_latents.to(dtype), xt.to(dtype)], dim=-1)
    pad = (-t_len) % patch
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    tp = (t_len + pad) // patch
    x = x.reshape(b, tp, patch * cfg.in_channels)
    x = linear(x, params["proj_in"]["kernel"], params["proj_in"]["bias"])

    enc = dit.compute_condition(params, cfg, encoder_hidden_states.to(dtype))
    kv = dit.compute_all_cross_kv(params, cfg, enc)

    cos, sin = rope_cos_sin(torch.arange(tp, device=dev), cfg.head_dim, base=cfg.rope_theta)
    cos, sin = cos.to(dtype), sin.to(dtype)
    lc = enc.shape[1]
    cross_mask = (make_attention_mask(tp, lc, kv_valid=encoder_attn_mask)
                  if encoder_attn_mask is not None else None)
    sliding_mask = make_attention_mask(tp, tp, sliding_window=cfg.sliding_window, device=dev)

    meshed = group is not None and group.size > 1
    maps = torch.zeros((b, tp, lc), dtype=torch.float32, device=dev)
    n_layers = 0
    for li, p in enumerate(iter_layers(params["layers"])):
        mod = p["scale_shift_table"].float()[None] + timestep_proj.float()
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
            mod[:, j:j + 1, :].to(dtype) for j in range(6)]
        sm = sliding_mask if cfg.layer_types[li] == "sliding_attention" else None
        normed = rms_norm(x, p["self_attn_norm"], cfg.rms_norm_eps)
        normed = normed * (1.0 + scale_msa) + shift_msa
        x = x + dit._self_attention(p["self_attn"], cfg, normed, cos, sin,
                                    lambda q, k, v, m=sm: attention(q, k, v, mask=m),
                                    group) * gate_msa

        normed = rms_norm(x, p["cross_attn_norm"], cfg.rms_norm_eps)
        probs = _cross_attn_probs(p["cross_attn"], cfg, normed, kv[li], cross_mask)
        maps += probs.sum(dim=1) if meshed else probs.mean(dim=1)
        x = x + dit._cross_attention(p["cross_attn"], cfg, normed, kv[li], cross_mask, group)

        normed = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        normed = normed * (1.0 + c_scale) + c_shift
        x = x + dit._mlp(p["mlp"], normed, group) * c_gate
        n_layers += 1
    if meshed:
        return all_reduce(maps, group) / (n_layers * cfg.num_attention_heads * group.size)
    return maps / n_layers


# ---------------------------------------------------------------------------
# DTW (monotonic alignment path)
# ---------------------------------------------------------------------------

def dtw_path(similarity: np.ndarray) -> List[Tuple[int, int]]:
    """Best monotonic path through a [T, N] similarity matrix (maximize sum).

    Moves: (t+1, n), (t, n+1), (t+1, n+1) — standard DTW on -similarity cost.
    Returns the path as (t, n) pairs, start to end."""
    sim = np.asarray(similarity, dtype=np.float64)
    t_len, n_len = sim.shape
    move = np.zeros((t_len, n_len), dtype=np.int8)   # 0:diag 1:up(t) 2:left(n)

    # Row-vectorized DP.  Within a row the only dependency is the "left" move:
    # row[n] = max(ub[n], row[n-1]) + s[n] with ub[n] = max(prev[n-1], prev[n]).
    # That max-plus recurrence has the closed form
    #   row[n] = S[n] + running_max_k<=n (g[k]),  g[k] = ub[k] - S[k-1]
    # with S the prefix sum of s — one cumsum + one maximum.accumulate.
    prev = np.cumsum(sim[0])               # cost[0, :] (left-only row)
    move[0, 1:] = 2
    for t in range(1, t_len):
        s = sim[t]
        S = np.cumsum(s)
        row0 = prev[0] + s[0]
        g = np.empty(n_len)
        g[0] = row0 - S[0]                 # == prev[0] (S[k-1] for k=0 is 0)
        ub = np.maximum(prev[:-1], prev[1:])
        g[1:] = ub - S[:-1]
        row = S + np.maximum.accumulate(g)
        row[0] = row0

        mv = np.zeros(n_len, np.int8)
        mv[0] = 1
        up_wins = (prev[1:] > prev[:-1]).astype(np.int8)       # up vs diag
        best_ud = np.maximum(prev[:-1], prev[1:])
        mv[1:] = np.where(row[:-1] > best_ud, np.int8(2), up_wins)
        move[t] = mv
        prev = row
    path = []
    t, n = t_len - 1, n_len - 1
    while True:
        path.append((t, n))
        if t == 0 and n == 0:
            break
        m = move[t, n]
        if m == 0:
            t, n = t - 1, n - 1
        elif m == 1:
            t -= 1
        else:
            n -= 1
        if t < 0 or n < 0:
            break
    path.reverse()
    return path


def token_timestamps(attn_map: np.ndarray, n_lyric_tokens: int,
                     patch_seconds: float) -> np.ndarray:
    """First-visit time (s) of each lyric token along the DTW path -> [Lc]."""
    path = dtw_path(attn_map[:, :n_lyric_tokens])
    stamps = np.full(n_lyric_tokens, -1.0)
    for t, n in path:
        if stamps[n] < 0:
            stamps[n] = t * patch_seconds
    # forward-fill any token never visited (degenerate paths)
    last = 0.0
    for i in range(n_lyric_tokens):
        if stamps[i] < 0:
            stamps[i] = last
        last = stamps[i]
    return stamps


def alignment_score(attn_map: np.ndarray, n_lyric_tokens: int) -> float:
    """Mean on-path attention mass over the mean mass: strong monotonic ridges
    score high, diffuse attention low."""
    sub = np.asarray(attn_map[:, :n_lyric_tokens], dtype=np.float64)
    if sub.size == 0:
        return 0.0
    path = dtw_path(sub)
    on_path = np.mean([sub[t, n] for t, n in path])
    return float(on_path / (sub.mean() + 1e-12))


def to_lrc(lines: Sequence[str], line_token_counts: Sequence[int], stamps: np.ndarray) -> str:
    """Sentence-level LRC: each line gets the timestamp of its first token."""
    out = []
    tok = 0
    for line, n in zip(lines, line_token_counts):
        t = stamps[min(tok, len(stamps) - 1)] if len(stamps) else 0.0
        m, s = divmod(max(t, 0.0), 60.0)
        out.append(f"[{int(m):02d}:{s:05.2f}]{line}")
        tok += n
    return "\n".join(out)
