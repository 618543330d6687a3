"""LM planner serving: batched prefill and autoregressive decode over the int8
KV cache (port of the JAX package's serving/lm.py, without tensor
parallelism).

Generation semantics (the JAX package's, from the reference engine):
  * temperature / top-k / top-p sampling (top-p by a 24-step bisection of the
    probability threshold, so the keep-set matches the JAX one);
  * stop-token sets (the CoT phase stops at ``</think>``);
  * codes phase: sampling restricted to the audio-code range plus EOS, EOS
    blocked before ``min_tokens`` and forced at ``forced_eos_at``; the vocab
    projection is cut to those columns (the reduced codes head);
  * classifier-free guidance with a paired unconditional cache.

The decode loop runs all ``max_new_tokens - 1`` steps as the JAX scan does,
each sequence frozen once it has stopped, and never reads a device value on
the host inside the loop: one generation call synchronises once, at the end.

A decode step takes one of three forms (``decode_step``):
  * ``decode_mega``: the whole step through the megakernel
    (ops/cuda/decode_mega.py) when ``supported`` says so; "auto" means on for
    CUDA tensors and off on the CPU;
  * the layer scan with the per-layer attention kernel
    (``decode_attn="pallas"``, ops/cuda/decode_attn.py row 9) or the fused
    prologue + attention kernel (``"fused"``, row 10);
  * the layer scan with the plain self-term attention
    (``attention_int8_self``; ``decode_attn="auto"`` or ``"xla"``).
``int8_act`` sends every q8_0 linear with at most 16 rows (the decode layers'
qkv, o_proj, gate-up and down on the layer scan, and the head on every form)
through the int8-activation kernel (ops/cuda/qmm_int8.py, row 6).
The JAX package reads these choices from ACESTEP_TPU_DECODE_MEGA / _DECODE_ATTN
/ _INT8_ACT / _REDUCED_CODES_HEAD / _KV_DTYPE / _LM_HEAD_QUANT; here they are
keyword arguments with the same defaults.  Random draws come from an explicit
torch.Generator on the logits' device (Gumbel-max sampling).

Caches are mutable here: a decode step writes the new token's K/V into the
cache it is given, so ``decode_from_state`` and ``extend_prefill`` work on
copies of the caches they are handed (a ``PrefixCache`` entry stays intact).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch.config import QwenConfig
from acestep_tpu_torch.models import qwen
from acestep_tpu_torch.models.stacking import iter_layers, layer_view, num_layers
from acestep_tpu_torch.ops import apply_rope, attention, linear, make_attention_mask, rms_norm
from acestep_tpu_torch.ops import rope_cos_sin, rotate_half
from acestep_tpu_torch.ops.cuda import decode_attn as _dattn
from acestep_tpu_torch.ops.cuda import decode_mega as _dmega
from acestep_tpu_torch.ops.qlinear import concat_weights_n, precast_quant_scales
from acestep_tpu_torch.quant import QuantTensor, quantize
from acestep_tpu_torch.serving import kv_cache as kvc
from acestep_tpu_torch.serving.kv_cache import KVCache

NEG_INF = -1e30
DECODE_MEGA = ("auto", "0", "1")
DECODE_ATTN = ("auto", "xla", "pallas", "fused")


# ---------------------------------------------------------------------------
# attention over the quantized cache
# ---------------------------------------------------------------------------

def _rope_at(positions: torch.Tensor, head_dim: int, base: float):
    """positions [B] -> cos / sin [B, 1, head_dim] f32 (single-token decode)."""
    cos, sin = rope_cos_sin(positions, head_dim, base)
    return cos[:, None, :], sin[:, None, :]


def _mm(x: torch.Tensor, dtype) -> torch.Tensor:
    """A matmul operand: rounded to the activation dtype (cache values are
    exact in bf16), computed in f32."""
    return x.to(dtype).float()


def attention_int8_self(q, kq, ks, vq, vs, bias, k_self, v_self):
    """Single-token GQA attention over the quantized cache plus an explicit
    self term for the current token (the cache is written once per step, after
    the layers).  q [B, Hq, 1, D]; kq / vq [B, Hkv, T, D]; ks / vs [B, Hkv, T];
    bias [B, 1, T] additive f32; k_self / v_self [B, Hkv, D]."""
    b, hq, tq, d = q.shape
    hkv = kq.shape[1]
    dtype = q.dtype
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bgrqd,bgtd->bgrqt", _mm(qg, dtype), _mm(kq, dtype)) * scale
    s = s * ks[:, :, None, None, :]
    s = s + bias[:, None, None, :, :].float()
    s_self = torch.einsum("bgrqd,bgd->bgrq", qg.float(), k_self.float())[..., None] * scale
    p = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1)
    p_cache, p_self = p[..., :-1], p[..., -1:]
    p_cache = p_cache * vs[:, :, None, None, :]
    out = torch.einsum("bgrqt,bgtd->bgrqd", _mm(p_cache, dtype), _mm(vq, dtype))
    out = out + p_self * v_self.float()[:, :, None, None, :]
    return out.reshape(b, hq, tq, d).to(dtype)


def attention_int8(q, kq, ks, vq, vs, bias):
    """GQA attention consuming the quantized cache directly: the per-vector
    scales fold into the score and value products.  q [B, Hq, Tq, D]; bias
    [B, Tq, T] or [B, 1, T]."""
    b, hq, tq, d = q.shape
    hkv = kq.shape[1]
    dtype = q.dtype
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bgrqd,bgtd->bgrqt", _mm(qg, dtype), _mm(kq, dtype)) * scale
    s = s * ks[:, :, None, None, :]
    s = s + bias[:, None, None, :, :].float()
    p = torch.softmax(s, dim=-1) * vs[:, :, None, None, :]
    out = torch.einsum("bgrqt,bgtd->bgrqd", _mm(p, dtype), _mm(vq, dtype))
    return out.reshape(b, hq, tq, d).to(dtype)


def _qkv_proj(p, xn, b: int, t: int, nh: int, nkv: int, hd: int, int8_act: bool = False):
    """q / k / v projections, through the fused qkv weight when present."""
    if "qkv_proj" in p:
        qkv = linear(xn, p["qkv_proj"]["kernel"], int8_act=int8_act)
        q = qkv[..., : nh * hd]
        k = qkv[..., nh * hd: (nh + nkv) * hd]
        v = qkv[..., (nh + nkv) * hd:]
    else:
        q = linear(xn, p["q_proj"]["kernel"], int8_act=int8_act)
        k = linear(xn, p["k_proj"]["kernel"], int8_act=int8_act)
        v = linear(xn, p["v_proj"]["kernel"], int8_act=int8_act)
    return q.reshape(b, t, nh, hd), k.reshape(b, t, nkv, hd), v.reshape(b, t, nkv, hd)


_NORMS = ("input_norm", "post_norm", "q_norm", "k_norm")


def fuse_serving_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fuse q||k||v and gate||up into single weights (4 matmuls a layer
    instead of 7, numerically exact) for stacked layers; quant scales and the
    layer norm weights are cast to f32 once (exact), as the kernels read them.
    No-op for a layer list."""
    layers = params.get("layers")
    if layers is None or isinstance(layers, list) or "qkv_proj" in layers:
        return params
    new_layers = dict(layers)
    new_layers["qkv_proj"] = {"kernel": concat_weights_n(
        [layers["q_proj"]["kernel"], layers["k_proj"]["kernel"], layers["v_proj"]["kernel"]])}
    new_layers["gateup_proj"] = {"kernel": concat_weights_n(
        [layers["gate_proj"]["kernel"], layers["up_proj"]["kernel"]])}
    for k in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        del new_layers[k]
    for k in _NORMS:
        new_layers[k] = new_layers[k].float()
    out = dict(params)
    out["layers"] = new_layers
    return precast_quant_scales(out)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _write_prompt(cache: KVCache, li: int, t: int, kq, ks, vq, vs) -> None:
    cache.k[li, :, :, :t] = kq
    cache.v[li, :, :, :t] = vq
    cache.k_scale[li, :, :, :t] = ks
    cache.v_scale[li, :, :, :t] = vs


@torch.no_grad()
def prefill(params: Dict[str, Any], cfg: QwenConfig, token_ids: torch.Tensor,
            lengths: torch.Tensor, cache: KVCache, *, int8_act: bool = False
            ) -> Tuple[torch.Tensor, KVCache]:
    """Causal forward over the right-padded prompt [B, T]; writes positions
    [0, T) of ``cache`` (in place) and returns the logits [B, vocab] f32 at
    each sequence's last valid position."""
    b, t = token_ids.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    eps, kv_dtype = cfg.rms_norm_eps, cache.kv_dtype
    x = params["embed_tokens"][token_ids]
    positions = torch.arange(t, device=x.device)
    cos, sin = rope_cos_sin(positions, hd, base=cfg.rope_theta)
    valid = (positions[None, :] < lengths[:, None]).to(torch.int32)
    mask = make_attention_mask(t, t, kv_valid=valid, causal=True)
    for li, p in enumerate(iter_layers(params["layers"])):
        xn = rms_norm(x, p["input_norm"], eps)
        q, k, v = _qkv_proj(p, xn, b, t, nh, nkv, hd, int8_act)
        q = rms_norm(q, p["q_norm"], eps).transpose(1, 2)
        k = rms_norm(k, p["k_norm"], eps).transpose(1, 2)
        v = v.transpose(1, 2)
        q, k = apply_rope(q, k, cos, sin)
        kq, ks = kvc.quantize_kv(k, kv_dtype)
        vq, vs = kvc.quantize_kv(v, kv_dtype)
        _write_prompt(cache, li, t, kq, ks, vq, vs)
        attn = attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, t, nh * hd)
        x = x + linear(attn, p["o_proj"]["kernel"], int8_act=int8_act)
        x = x + qwen.mlp_block(p, rms_norm(x, p["post_norm"], eps), int8_act)
    cache.length = lengths.to(torch.int32)
    x = rms_norm(x, params["norm"], eps)
    last = x[torch.arange(b, device=x.device), (lengths - 1).long()]
    logits = qwen.lm_logits(params, cfg, last[:, None, :], int8_act)[:, 0, :]
    return logits.float(), cache


@torch.no_grad()
def extend_prefill(params: Dict[str, Any], cfg: QwenConfig, cache: KVCache,
                   new_ids: torch.Tensor, start: torch.Tensor,
                   suffix_lengths: Optional[torch.Tensor] = None, *,
                   int8_act: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Prefill a suffix [B, T2] (right-padded to a bucket; ``suffix_lengths``
    valid) at positions [start, start + len) of a copy of ``cache``; returns the
    logits at the last valid suffix position and the extended copy."""
    b, t2 = new_ids.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    eps, kv_dtype = cfg.rms_norm_eps, cache.kv_dtype
    dev = new_ids.device
    cache = cache.clone()
    t_max = cache.max_len
    if suffix_lengths is None:
        suffix_lengths = torch.full((b,), t2, dtype=torch.int32, device=dev)
    x = params["embed_tokens"][new_ids]
    offs = torch.arange(t2, device=dev)[None, :]
    pos = start.long()[:, None] + offs                               # [B, T2]
    pad = offs >= suffix_lengths.long()[:, None]
    cos, sin = (t.view(b, 1, t2, hd) for t in rope_cos_sin(pos.reshape(-1), hd,
                                                            cfg.rope_theta))
    kpos = torch.arange(t_max, device=dev)[None, None, :]
    cache_bias = torch.where(kpos <= pos[:, :, None], 0.0, NEG_INF).float()   # [B, T2, T]
    # pad positions are not written (the JAX scatter drops them out of bounds)
    wb, wt = (~pad).nonzero(as_tuple=True)
    wpos = pos[wb, wt]
    for li, p in enumerate(iter_layers(params["layers"])):
        xn = rms_norm(x, p["input_norm"], eps)
        q, k, v = _qkv_proj(p, xn, b, t2, nh, nkv, hd, int8_act)
        q = rms_norm(q, p["q_norm"], eps).transpose(1, 2)
        k = rms_norm(k, p["k_norm"], eps).transpose(1, 2)
        v = v.transpose(1, 2)
        # f32 rope terms promote q and k (and from here the residual) to f32,
        # as in the JAX function
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        kq, ks = kvc.quantize_kv(k, kv_dtype)
        vq, vs = kvc.quantize_kv(v, kv_dtype)
        cache.k[li][wb, :, wpos] = kq.transpose(1, 2)[wb, wt]
        cache.v[li][wb, :, wpos] = vq.transpose(1, 2)[wb, wt]
        cache.k_scale[li][wb, :, wpos] = ks.transpose(1, 2)[wb, wt]
        cache.v_scale[li][wb, :, wpos] = vs.transpose(1, 2)[wb, wt]
        attn = attention_int8(q, cache.k[li], cache.k_scale[li], cache.v[li],
                              cache.v_scale[li], cache_bias)
        attn = attn.transpose(1, 2).reshape(b, t2, nh * hd)
        x = x + linear(attn, p["o_proj"]["kernel"], int8_act=int8_act)
        x = x + qwen.mlp_block(p, rms_norm(x, p["post_norm"], eps), int8_act)
    cache.length = (start + suffix_lengths).to(torch.int32)
    x = rms_norm(x, params["norm"], eps)
    last = x[torch.arange(b, device=dev), (suffix_lengths - 1).long()]
    logits = qwen.lm_logits(params, cfg, last[:, None, :], int8_act)[:, 0, :]
    return logits.float(), cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def check_knobs(decode_mega: str, decode_attn: str, int8_act: bool = False) -> None:
    if decode_mega not in DECODE_MEGA:
        raise ValueError(f"decode_mega={decode_mega!r}: expected one of {DECODE_MEGA}")
    if decode_attn not in DECODE_ATTN:
        raise ValueError(f"decode_attn={decode_attn!r}: expected one of {DECODE_ATTN}")
    if not isinstance(int8_act, bool):
        raise ValueError(f"int8_act={int8_act!r}: expected True or False")


def _write_token(cache: KVCache, k_new, ks_new, v_new, vs_new) -> None:
    """Write each sequence's new K/V [L, B, Hkv, D] at its ``length`` (in place,
    no host read of the lengths)."""
    bidx = torch.arange(k_new.shape[1], device=k_new.device)
    pos = cache.length.long()
    cache.k[:, bidx, :, pos] = k_new.transpose(0, 1).to(cache.k.dtype)
    cache.v[:, bidx, :, pos] = v_new.transpose(0, 1).to(cache.v.dtype)
    cache.k_scale[:, bidx, :, pos] = ks_new.transpose(0, 1)
    cache.v_scale[:, bidx, :, pos] = vs_new.transpose(0, 1)


def _use_mega(params, cfg, cache: KVCache, b: int, decode_mega: str, device) -> bool:
    if decode_mega == "0" or (decode_mega == "auto" and device.type != "cuda"):
        return False
    if isinstance(params["layers"], list) or cache.kv_dtype != "int8":
        return False
    return _dmega.supported(params["layers"], cfg, b, cache.max_len)


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: QwenConfig, cache: KVCache,
                token_ids: torch.Tensor, head=None, *, decode_mega: str = "auto",
                decode_attn: str = "auto", int8_act: bool = False
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode position at each sequence's current length -> logits
    [B, vocab] f32.  The new token's K/V are written into ``cache`` (in place)
    at ``length``; the caller advances the lengths.  ``head`` overrides the
    vocab projection (the reduced codes head)."""
    check_knobs(decode_mega, decode_attn, int8_act)
    b = token_ids.shape[0]
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    eps, kv_dtype, t_max = cfg.rms_norm_eps, cache.kv_dtype, cache.max_len
    x = params["embed_tokens"][token_ids][:, None, :]                 # [B, 1, H]
    cos, sin = _rope_at(cache.length, hd, cfg.rope_theta)
    pos_ids = torch.arange(t_max, device=x.device)
    layers = params["layers"]

    if _use_mega(params, cfg, cache, b, decode_mega, x.device):
        x_res, k_new, ks_new, v_new, vs_new = _dmega.decode_layers_mega(
            layers, cfg, cache.k, cache.k_scale, cache.v, cache.v_scale, cache.length,
            x[:, 0, :], cos[:, 0, :], sin[:, 0, :])
        x = x_res.to(x.dtype)[:, None, :]
        _write_token(cache, k_new, ks_new, v_new, vs_new)
    elif not isinstance(layers, list):
        # read-only layer scan: the current token enters through the self term
        # and the cache is written once, after the layers
        kernel_ok = kv_dtype == "int8" and _dattn.takes(nh, nkv, hd, t_max)
        fused = decode_attn == "fused" and kernel_ok
        pattn = decode_attn == "pallas" and kernel_ok
        bias_strict = torch.where(pos_ids[None, :] < cache.length[:, None], 0.0,
                                  NEG_INF).float()[:, None, :]
        news = []
        for li in range(num_layers(layers)):
            p = layer_view(layers, li)
            xn = rms_norm(x, p["input_norm"], eps)
            q, k, v = _qkv_proj(p, xn, b, 1, nh, nkv, hd, int8_act)
            if fused:
                out, kq_new, ks_new, vq_new, vs_new = _dattn.decode_attention_fused_stacked(
                    q[:, 0], k[:, 0], v[:, 0], p["q_norm"], p["k_norm"], cos[:, 0],
                    sin[:, 0], cache.k, cache.k_scale, cache.v, cache.v_scale,
                    cache.length, li, eps)
                attn = out.to(x.dtype).reshape(b, 1, nh * hd)
            else:
                q = rms_norm(q, p["q_norm"], eps).transpose(1, 2)
                k = rms_norm(k, p["k_norm"], eps).transpose(1, 2)
                v = v.transpose(1, 2)
                q, k = apply_rope(q, k, cos[:, None], sin[:, None])
                k_self, v_self = k[:, :, 0, :], v[:, :, 0, :]
                kq_new, ks_new = kvc.quantize_kv(k_self, kv_dtype)
                vq_new, vs_new = kvc.quantize_kv(v_self, kv_dtype)
                if pattn:
                    attn = _dattn.decode_attention_int8_stacked(
                        q[:, :, 0, :], cache.k, cache.k_scale, cache.v, cache.v_scale,
                        cache.length, li, k_self, v_self)
                    attn = attn.to(q.dtype).reshape(b, 1, nh * hd)
                else:
                    attn = attention_int8_self(q, cache.k[li], cache.k_scale[li],
                                               cache.v[li], cache.v_scale[li], bias_strict,
                                               k_self, v_self)
                    attn = attn.transpose(1, 2).reshape(b, 1, nh * hd)
            x = x + linear(attn, p["o_proj"]["kernel"], int8_act=int8_act)
            x = x + qwen.mlp_block(p, rms_norm(x, p["post_norm"], eps), int8_act)
            news.append((kq_new, ks_new, vq_new, vs_new))
        _write_token(cache, *(torch.stack([n[i] for n in news]) for i in range(4)))
    else:
        # layer list: each layer writes the new token first, then attends to
        # [0, length] of its cache slice
        bias = torch.where(pos_ids[None, :] <= cache.length[:, None], 0.0,
                           NEG_INF).float()[:, None, :]
        bidx = torch.arange(b, device=x.device)
        pos = cache.length.long()
        for li, p in enumerate(layers):
            xn = rms_norm(x, p["input_norm"], eps)
            q, k, v = _qkv_proj(p, xn, b, 1, nh, nkv, hd, int8_act)
            q = rms_norm(q, p["q_norm"], eps).transpose(1, 2)
            k = rms_norm(k, p["k_norm"], eps).transpose(1, 2)
            v = v.transpose(1, 2)
            q, k = apply_rope(q, k, cos[:, None], sin[:, None])
            kq_new, ks_new = kvc.quantize_kv(k[:, :, 0, :], kv_dtype)
            vq_new, vs_new = kvc.quantize_kv(v[:, :, 0, :], kv_dtype)
            cache.k[li][bidx, :, pos] = kq_new
            cache.v[li][bidx, :, pos] = vq_new
            cache.k_scale[li][bidx, :, pos] = ks_new
            cache.v_scale[li][bidx, :, pos] = vs_new
            attn = attention_int8(q, cache.k[li], cache.k_scale[li], cache.v[li],
                                  cache.v_scale[li], bias)
            x = x + linear(attn.transpose(1, 2).reshape(b, 1, nh * hd), p["o_proj"]["kernel"],
                           int8_act=int8_act)
            x = x + qwen.mlp_block(p, rms_norm(x, p["post_norm"], eps), int8_act)

    x = rms_norm(x, params["norm"], eps)
    if head is not None:
        logits = linear(x, head, int8_act=int8_act)[:, 0, :]
    else:
        logits = qwen.lm_logits(params, cfg, x, int8_act)[:, 0, :]
    return logits.float(), cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _top_p_threshold(probs: torch.Tensor, top_p: float, iters: int = 24) -> torch.Tensor:
    """Largest probability threshold t with mass{p >= t} >= top_p, per row, by
    bisection (``iters`` masked sums instead of a vocab sort)."""
    pmax = probs.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(pmax)
    hi = pmax * (1.0 + 1e-6) + 1e-12
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid, probs, 0.0).sum(-1, keepdim=True)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def sample_logits(gen: Optional[torch.Generator], logits: torch.Tensor,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Sample one token per row of ``logits`` [B, V] f32 -> [B] int32.
    Temperature 0 is greedy; otherwise Gumbel-max over the filtered logits
    with noise from ``gen``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        thr = _top_p_threshold(probs, top_p)
        logits = torch.where(probs < thr, torch.full_like(logits, NEG_INF), logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _layers_quantized(layers) -> bool:
    if isinstance(layers, dict):
        return any(_layers_quantized(v) for v in layers.values())
    if isinstance(layers, list):
        return any(_layers_quantized(v) for v in layers)
    return isinstance(layers, QuantTensor)


@torch.no_grad()
def ensure_quantized_head(params: Dict[str, Any], fmt: Optional[str] = "q8_0"
                          ) -> Dict[str, Any]:
    """Give a tied-embedding LM with quantized layers a quantized ``lm_head``
    copy ``[H, V + pad]`` (vocab padded to a multiple of 2048; ``lm_logits``
    slices the pad off), so decode never streams the bf16 embedding matrix.
    ``fmt`` None / "none" keeps the tied head; unquantized layers keep it too."""
    if params.get("lm_head") is not None or not _layers_quantized(params.get("layers")):
        return params
    if fmt in (None, "none", "0", ""):
        return params
    emb = params["embed_tokens"]
    if emb.shape[1] % 256:
        return params
    pad = (-emb.shape[0]) % 2048
    w = emb.float().t()
    if pad:
        w = torch.cat([w, torch.zeros((w.shape[0], pad), dtype=w.dtype, device=w.device)], 1)
    out = dict(params)
    out["lm_head"] = {"kernel": quantize(w.contiguous(), fmt)}
    return out


def _slice_head_cols(w, lo: int, hi: int, eos: Optional[int], pad_multiple: int = 2048):
    """Column-slice a head weight [K, V] to ``[lo, hi)`` plus the EOS column,
    zero-padded to a multiple of ``pad_multiple`` (every quant field packs
    along K, so each slices along N).  Returns (weight, n_range, n_valid)."""
    n_range = hi - lo
    n_valid = n_range + (1 if eos is not None else 0)
    pad = (-n_valid) % pad_multiple

    def cut(a):
        parts = [a[..., lo:hi]]
        if eos is not None:
            parts.append(a[..., eos:eos + 1])
        if pad:
            parts.append(torch.zeros(a.shape[:-1] + (pad,), dtype=a.dtype, device=a.device))
        return torch.cat(parts, dim=-1).contiguous()

    if isinstance(w, QuantTensor):
        red = QuantTensor(w.fmt, (w.shape[0], n_valid + pad),
                          **{f: cut(a) for f, a in w.fields().items()})
    else:
        red = cut(w)
    return red, n_range, n_valid


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.85
    top_k: int = 0
    top_p: float = 0.95
    max_new_tokens: int = 256
    stop_tokens: Tuple[int, ...] = ()
    # constrained codes phase
    allowed_range: Optional[Tuple[int, int]] = None   # [lo, hi)
    eos_token: Optional[int] = None
    min_tokens: int = 0               # EOS blocked before this many new tokens
    forced_eos_at: Optional[int] = None  # EOS forced from this count on
    cfg_scale: float = 1.0            # > 1 enables paired-uncond guidance


def _scan_decode(params, cfg, sp: SamplingParams, b: int, cache: KVCache, logits, gen,
                 ucache: Optional[KVCache] = None, ulogits=None, min_tokens_arr=None,
                 forced_eos_arr=None, *, reduced_codes_head: bool = True,
                 decode_mega: str = "auto", decode_attn: str = "auto", int8_act: bool = False):
    """Sample from ``logits`` then run ``max_new_tokens - 1`` cached decode
    steps (every step, as the JAX scan; finished rows are frozen).
    ``min_tokens_arr`` / ``forced_eos_arr`` [B] are per-row overrides of
    ``sp.min_tokens`` / ``sp.forced_eos_at``.  Returns (tokens [B, max_new]
    int32 with -1 after a row's stop, n_generated [B]) on the device."""
    check_knobs(decode_mega, decode_attn, int8_act)
    dev = logits.device
    use_cfg = sp.cfg_scale != 1.0 and ucache is not None
    if use_cfg:
        logits = ulogits + sp.cfg_scale * (logits - ulogits)

    head_red = None
    n_range = n_valid = 0
    if sp.allowed_range is not None and reduced_codes_head:
        w_full = (params.get("lm_head") or {}).get("kernel")
        if w_full is None:
            w_full = params["embed_tokens"].t()                     # tied
        head_red, n_range, n_valid = _slice_head_cols(
            w_full, sp.allowed_range[0], sp.allowed_range[1], sp.eos_token)

    vocab = logits.shape[-1]
    vocab_ids = torch.arange(vocab, device=dev)
    range_mask = None
    if sp.allowed_range is not None:
        lo, hi = sp.allowed_range
        range_mask = (vocab_ids >= lo) & (vocab_ids < hi)
        if sp.eos_token is not None:
            range_mask = range_mask | (vocab_ids == sp.eos_token)
    stop_set = (torch.tensor(sp.stop_tokens, dtype=torch.int32, device=dev)
                if sp.stop_tokens else None)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    def eos_rules(lg, step, is_eos, not_eos):
        if min_tokens_arr is not None:
            lg = torch.where((step < min_tokens_arr[:, None]) & is_eos, neg, lg)
        elif sp.min_tokens > 0 and step < sp.min_tokens:
            lg = torch.where(is_eos, neg, lg)
        if forced_eos_arr is not None:
            lg = torch.where((step >= forced_eos_arr[:, None]) & not_eos, neg, lg)
        elif sp.forced_eos_at is not None and step >= sp.forced_eos_at:
            lg = torch.where(not_eos, neg, lg)
        return lg

    # the step-independent masks, built once
    full_eos = None if sp.eos_token is None else (vocab_ids == sp.eos_token)[None, :]
    red_pad = red_eos = None
    if head_red is not None:
        red_cols = torch.arange(head_red.shape[-1], device=dev)[None, :]
        red_pad = red_cols >= n_valid
        red_eos = red_cols == n_range

    def constrain(lg, step):
        if range_mask is not None:
            lg = torch.where(range_mask[None, :], lg, neg)
        if full_eos is not None:
            lg = eos_rules(lg, step, full_eos, ~full_eos)
        return lg

    def constrain_red(lr, step):
        """Reduced-space constrain: column j is token lo + j, column n_range
        is EOS, columns >= n_valid are padding."""
        lr = torch.where(red_pad, neg, lr)
        if sp.eos_token is not None:
            lr = eos_rules(lr, step, red_eos, ~red_eos)
        return lr

    def map_red(tok_red):
        full = sp.allowed_range[0] + tok_red
        if sp.eos_token is not None:
            full = torch.where(tok_red == n_range, torch.full_like(full, sp.eos_token), full)
        return full.to(torch.int32)

    def is_stop(tok):
        s = torch.zeros_like(tok, dtype=torch.bool)
        if stop_set is not None:
            s = s | (tok[:, None] == stop_set[None, :]).any(-1)
        if sp.eos_token is not None:
            s = s | (tok == sp.eos_token)
        return s

    knobs = dict(decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act)
    cur = sample_logits(gen, constrain(logits, 0), sp.temperature, sp.top_k, sp.top_p)
    first_tok = cur
    finished = is_stop(cur)
    ones = torch.ones((b,), dtype=torch.bool, device=dev)
    out = [cur]
    for step in range(sp.max_new_tokens - 1):
        lg, cache = decode_step(params, cfg, cache, cur, head=head_red, **knobs)
        cache = kvc.advance(cache, ones)
        if use_cfg:
            ulg, ucache = decode_step(params, cfg, ucache, cur, head=head_red, **knobs)
            ucache = kvc.advance(ucache, ones)
            lg = ulg + sp.cfg_scale * (lg - ulg)
        if head_red is not None:
            nxt = map_red(sample_logits(gen, constrain_red(lg, step + 1), sp.temperature,
                                        sp.top_k, sp.top_p))
        else:
            nxt = sample_logits(gen, constrain(lg, step + 1), sp.temperature, sp.top_k,
                                sp.top_p)
        nxt = torch.where(finished, cur, nxt)           # frozen once finished
        out.append(torch.where(finished, torch.full_like(nxt, -1), nxt))
        finished = finished | is_stop(nxt)
        cur = nxt

    tokens = torch.stack(out, dim=1)                    # [B, max_new]
    stops = torch.cat([is_stop(first_tok)[:, None],
                       (tokens[:, 1:] == -1) | is_stop(tokens[:, 1:].reshape(-1)).reshape(
                           b, -1)], dim=1)
    any_stop = stops.any(dim=1)
    first_stop = torch.argmax(stops.to(torch.int32), dim=1)
    n_gen = torch.where(any_stop, first_stop + 1, torch.full_like(first_stop, sp.max_new_tokens))
    return tokens, n_gen.to(torch.int32)


@torch.no_grad()
def generate(params: Dict[str, Any], cfg: QwenConfig, prompt_ids: torch.Tensor,
             prompt_lengths: torch.Tensor, gen: Optional[torch.Generator], sp: SamplingParams,
             uncond_prompt_ids: Optional[torch.Tensor] = None,
             uncond_prompt_lengths: Optional[torch.Tensor] = None,
             min_tokens_arr=None, forced_eos_arr=None, *, kv_dtype: str = "int8",
             reduced_codes_head: bool = True, decode_mega: str = "auto",
             decode_attn: str = "auto", int8_act: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate up to ``max_new_tokens`` per prompt row [B, T] (right-padded);
    returns (tokens [B, max_new], n_generated [B]) on the prompt's device."""
    b, t_prompt = prompt_ids.shape
    dev = prompt_ids.device
    n_layers = cfg.num_hidden_layers
    max_len = kvc.round_len(t_prompt + sp.max_new_tokens + 1)
    cache = kvc.init_cache(n_layers, b, cfg.num_key_value_heads, max_len, cfg.head_dim,
                           kv_dtype, dev)
    logits, cache = prefill(params, cfg, prompt_ids, prompt_lengths, cache, int8_act=int8_act)
    ucache = ulogits = None
    if sp.cfg_scale != 1.0 and uncond_prompt_ids is not None:
        u_max = kvc.round_len(uncond_prompt_ids.shape[1] + sp.max_new_tokens + 1)
        ucache = kvc.init_cache(n_layers, b, cfg.num_key_value_heads, u_max, cfg.head_dim,
                                kv_dtype, dev)
        ulogits, ucache = prefill(params, cfg, uncond_prompt_ids, uncond_prompt_lengths,
                                  ucache, int8_act=int8_act)
    return _scan_decode(params, cfg, sp, b, cache, logits, gen, ucache, ulogits,
                        min_tokens_arr, forced_eos_arr, reduced_codes_head=reduced_codes_head,
                        decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act)


@torch.no_grad()
def decode_from_state(params: Dict[str, Any], cfg: QwenConfig, cache: KVCache, logits,
                      gen: Optional[torch.Generator], sp: SamplingParams,
                      ucache: Optional[KVCache] = None, ulogits=None, min_tokens_arr=None,
                      forced_eos_arr=None, *, reduced_codes_head: bool = True,
                      decode_mega: str = "auto", decode_attn: str = "auto",
                      int8_act: bool = False):
    """The decode loop from an existing prefilled state (the prefix-cache
    path); runs on copies of the caches."""
    b = logits.shape[0]
    return _scan_decode(params, cfg, sp, b, cache.clone(), logits, gen,
                        None if ucache is None else ucache.clone(), ulogits, min_tokens_arr,
                        forced_eos_arr, reduced_codes_head=reduced_codes_head,
                        decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act)


# ---------------------------------------------------------------------------
# constrained CoT: the metadata FSM on the host, or its compiled DFA on the
# device
# ---------------------------------------------------------------------------

def _fsm_prefill(params, cfg: QwenConfig, prompt_ids: Sequence[int], max_new_tokens: int,
                 kv_dtype: str, int8_act: bool):
    """The unbucketed batch-1 prompt prefilled, on the params' device, into a
    fresh cache with room for ``max_new_tokens`` more positions."""
    device = params["embed_tokens"].device
    ids = torch.tensor([list(prompt_ids)], dtype=torch.int64, device=device)
    lengths = torch.tensor([len(prompt_ids)], dtype=torch.int32, device=device)
    cache = kvc.init_cache(cfg.num_hidden_layers, 1, cfg.num_key_value_heads,
                           kvc.round_len(len(prompt_ids) + max_new_tokens + 1), cfg.head_dim,
                           kv_dtype, device)
    return prefill(params, cfg, ids, lengths, cache, int8_act=int8_act)


@torch.no_grad()
def generate_with_fsm(params: Dict[str, Any], cfg: QwenConfig, prompt_ids: Sequence[int], fsm,
                      vocab_strs: Sequence[str], gen: Optional[torch.Generator],
                      temperature: float = 0.7, max_new_tokens: int = 256, *,
                      kv_dtype: str = "int8", decode_mega: str = "auto",
                      decode_attn: str = "auto", int8_act: bool = False) -> Tuple[list, str]:
    """Generate one sequence under the host-stepped ``constrained.MetadataFSM``,
    on the params' device: the prompt's prefill, then one decode step a token,
    each token drawn from the logits masked by ``fsm.allowed`` (greedy at
    temperature 0, else Gumbel-max from ``gen``).  Stops when the FSM is done
    or its mask is empty.  Returns (token ids, text)."""
    knobs = dict(decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act)
    logits, cache = _fsm_prefill(params, cfg, prompt_ids, max_new_tokens, kv_dtype, int8_act)
    device = logits.device
    vocab = len(vocab_strs)
    ones = torch.ones((1,), dtype=torch.bool, device=device)
    out_ids: List[int] = []
    out_text: List[str] = []
    for _ in range(max_new_tokens):
        if fsm.done:
            break
        mask = fsm.allowed(vocab_strs)
        if not mask.any():
            break
        lg = torch.where(torch.from_numpy(mask).to(device), logits[0, :vocab], NEG_INF)
        tok = int(sample_logits(gen, lg[None], temperature)[0])
        piece = vocab_strs[tok]
        out_ids.append(tok)
        out_text.append(piece)
        fsm.step(piece)
        logits, cache = decode_step(params, cfg, cache,
                                    torch.tensor([tok], dtype=torch.int64, device=device),
                                    **knobs)
        cache = kvc.advance(cache, ones)
    return out_ids, "".join(out_text)


DFA_TABLES = ("masks_packed", "default_next", "exc_tok", "exc_next", "exc_cap", "is_caption",
              "cap_len", "has_nl")
_DFA_INDEX_TABLES = ("default_next", "exc_tok", "exc_next")        # held as int64


def dfa_tables(dfa, device: torch.device) -> Dict[str, torch.Tensor]:
    """The compiled DFA's tables on ``device``, uploaded once per (DFA, device)
    and cached on the DFA object.  The packed uint32 mask words are held as
    int32 (the same bits): the unpack shifts them as int32."""
    if getattr(dfa, "_device_arrays", None) is None:
        dfa._device_arrays = {}
    key = str(device)
    if key not in dfa._device_arrays:
        tabs = {}
        for name in DFA_TABLES:
            a = getattr(dfa, name)
            t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)
            tabs[name] = t.long() if name in _DFA_INDEX_TABLES else t
        dfa._device_arrays[key] = tabs
    return dfa._device_arrays[key]


@torch.no_grad()
def _dfa_decode(params, cfg: QwenConfig, prompt_ids: Sequence[int], dfa, gen,
                temperature: float, max_new_tokens: int, *, kv_dtype: str = "int8",
                check_every: int = 16, decode_mega: str = "auto", decode_attn: str = "auto",
                int8_act: bool = False) -> torch.Tensor:
    """Constrained decode of one sequence under the compiled DFA, its state on
    the device (the JAX package's ``_dfa_decode`` while_loop).  Each step
    gathers the state's packed mask row, unpacks it against the vocabulary,
    applies the caption char budget, samples, and moves to ``exc_next`` where
    the token is one of the state's exceptions, else to ``default_next``.  The
    loop stops on the done state or on an empty mask (no token emitted).

    The host reads the done flag once every ``check_every`` steps and nowhere
    else; steps run after the stop leave the state frozen and emit nothing, so
    the tokens are the same whatever ``check_every`` is.  Returns the emitted
    token ids [n] on the device."""
    knobs = dict(decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act)
    logits, cache = _fsm_prefill(params, cfg, prompt_ids, max_new_tokens, kv_dtype, int8_act)
    device = logits.device
    tabs = dfa_tables(dfa, device)
    v = dfa.vocab_size
    vocab_model = logits.shape[-1]
    vids = torch.arange(v, device=device)
    widx, wshift = vids // 32, (vids % 32).to(torch.int32)
    cap_len, has_nl = tabs["cap_len"], tabs["has_nl"]
    max_cap, done_state = dfa.max_caption_chars, dfa.done_state
    state = torch.tensor(dfa.start_state, dtype=torch.int64, device=device)
    used = torch.zeros((), dtype=torch.int32, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    ones = torch.ones((1,), dtype=torch.bool, device=device)
    neg = torch.full((vocab_model,), NEG_INF, dtype=logits.dtype, device=device)
    toks: List[torch.Tensor] = []
    for step in range(max_new_tokens):
        row = tabs["masks_packed"][state]                                  # [W] int32
        allowed = ((row[widx] >> wshift) & 1).bool()
        cap_ok = (used + cap_len <= max_cap) & (~has_nl | (used + cap_len > 0))
        allowed = allowed & (cap_ok | ~tabs["is_caption"][state])
        stuck = ~allowed.any()
        lg = torch.cat([torch.where(allowed, logits[0, :v], NEG_INF), neg[v:]])
        tok = sample_logits(gen, lg[None], temperature)[0].long()
        hits = tabs["exc_tok"][state] == tok
        hit = hits.any()
        j = torch.argmax(hits.to(torch.int32))
        nxt = torch.where(hit, tabs["exc_next"][state][j], tabs["default_next"][state])
        # a token drawn from an empty mask may lie past the table (not emitted)
        delta = torch.where(hit, tabs["exc_cap"][state][j],
                            torch.where(tabs["is_caption"][state],
                                        cap_len[tok.clamp(max=v - 1)], 0))
        live = ~done
        toks.append(torch.where(live & ~stuck, tok, -1))
        state = torch.where(live, nxt, state)
        used = torch.where(live, used + delta, used)
        done = done | (nxt == done_state) | stuck
        logits, cache = decode_step(params, cfg, cache, tok[None], **knobs)
        cache = kvc.advance(cache, ones)
        if (step + 1) % check_every == 0 and bool(done):
            break
    out = torch.stack(toks)
    return out[out >= 0]


def generate_with_fsm_device(params: Dict[str, Any], cfg: QwenConfig,
                             prompt_ids: Sequence[int], dfa, vocab_strs: Sequence[str],
                             gen: Optional[torch.Generator], temperature: float = 0.7,
                             max_new_tokens: int = 256, **kw) -> Tuple[list, str]:
    """The device counterpart of :func:`generate_with_fsm` under a
    ``constrained.CompiledDFA``: the whole constrained block with its state on
    the params' device.  ``kw``: ``_dfa_decode``'s keywords.  Returns (token
    ids, text)."""
    toks = _dfa_decode(params, cfg, prompt_ids, dfa, gen, temperature, max_new_tokens, **kw)
    out_ids = [int(t) for t in toks.cpu().tolist()]
    return out_ids, "".join(vocab_strs[t] for t in out_ids)


# ---------------------------------------------------------------------------
# prefix caching
# ---------------------------------------------------------------------------

class PrefixCache:
    """LRU cache of prefill KV states keyed by the exact prompt-token prefix."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._store: "dict[tuple, tuple]" = {}
        self._order: List[tuple] = []
        self.hits = 0
        self.misses = 0

    def lookup(self, ids: Sequence[int]):
        """Longest cached prefix of ids -> (prefix_len, cache, logits) or None.
        The cache is the stored one: callers must not write into it."""
        best = None
        for key in self._store:
            n = len(key)
            if n <= len(ids) and tuple(ids[:n]) == key and (best is None or n > best):
                best = n
        if best is None:
            self.misses += 1
            return None
        self.hits += 1
        key = tuple(ids[:best])
        self._order.remove(key)
        self._order.append(key)
        cache, logits = self._store[key]
        return best, cache, logits

    def insert(self, ids: Sequence[int], cache: KVCache, logits) -> None:
        key = tuple(ids)
        if key in self._store:
            return
        self._store[key] = (cache, logits)
        self._order.append(key)
        while len(self._order) > self.max_entries:
            del self._store[self._order.pop(0)]
