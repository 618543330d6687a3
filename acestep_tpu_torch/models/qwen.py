"""Qwen3 transformer in PyTorch (text encoder and LM planner backbone): port of
the JAX package's models/qwen.py.

Per layer: RMSNorm -> GQA attention with per-head q/k RMSNorm + NEOX RoPE ->
residual -> RMSNorm -> SwiGLU MLP -> residual; final RMSNorm.  Params are a
plain dict; every ``*_proj`` kernel is ``[K, N]`` and may be a
QuantTensor; the serving path fuses q||k||v into ``qkv_proj`` and gate||up into
``gateup_proj`` (serving/lm.py).  ``layers`` is a list of per-layer dicts, or (after
:func:`stack_params`) one dict whose leaves carry a leading layer axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from acestep_tpu_torch.config import QwenConfig
from acestep_tpu_torch.ops import (
    apply_rope,
    attention,
    linear,
    make_attention_mask,
    rms_norm,
    rope_cos_sin,
    silu,
)
from acestep_tpu_torch.models.stacking import iter_layers, stack_layer_params

Params = Dict[str, Any]


def init_params(cfg: QwenConfig, device=None, seed: int = 0, quant: Optional[str] = None,
                dtype=torch.bfloat16) -> Params:
    """Random params (stacked layers), drawn and quantized on ``device`` one
    tensor at a time with a seeded torch.Generator there, so a full-width model
    never sits in host memory.  ``quant``: None (``dtype`` kernels) or a quant
    format for every kernel large enough (models/random_init.py)."""
    from acestep_tpu_torch.models.random_init import RandomInit

    dev = torch.device("cuda" if device is None else device)
    return RandomInit(dev, seed, quant, dtype=dtype).qwen(cfg)


def stack_params(params: Params) -> Params:
    if isinstance(params.get("layers"), list):
        params = dict(params)
        params["layers"] = stack_layer_params(params["layers"])
    return params


def attention_block(p: Params, cfg: QwenConfig, x, cos, sin, mask):
    b, l, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    if "qkv_proj" in p:              # serving-fused q||k||v (the LM's params)
        qkv = linear(x, p["qkv_proj"]["kernel"])
        q = qkv[..., : nh * hd].reshape(b, l, nh, hd)
        k = qkv[..., nh * hd: (nh + nkv) * hd].reshape(b, l, nkv, hd)
        v = qkv[..., (nh + nkv) * hd:].reshape(b, l, nkv, hd)
    else:
        q = linear(x, p["q_proj"]["kernel"]).reshape(b, l, nh, hd)
        k = linear(x, p["k_proj"]["kernel"]).reshape(b, l, nkv, hd)
        v = linear(x, p["v_proj"]["kernel"]).reshape(b, l, nkv, hd)
    q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps).transpose(1, 2)
    k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps).transpose(1, 2)
    v = v.transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    out = attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, l, nh * hd)
    return linear(out, p["o_proj"]["kernel"])


def mlp_block(p: Params, x, int8_act: bool = False):
    """SwiGLU MLP, through the fused gate||up weight when present."""
    if "gateup_proj" in p:
        gu = linear(x, p["gateup_proj"]["kernel"], int8_act=int8_act)
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = linear(x, p["gate_proj"]["kernel"], int8_act=int8_act)
        up = linear(x, p["up_proj"]["kernel"], int8_act=int8_act)
    act = silu(gate.float()).to(x.dtype) * up
    return linear(act, p["down_proj"]["kernel"], int8_act=int8_act)


def forward(params: Params, cfg: QwenConfig, token_ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None, *, causal: bool = True,
            final_norm: bool = True) -> torch.Tensor:
    """Full-sequence forward: token_ids [B, L] -> hidden states [B, L, H]."""
    b, l = token_ids.shape
    x = embeddings_only(params, token_ids)
    cos, sin = rope_cos_sin(torch.arange(l, device=x.device), cfg.head_dim,
                            base=cfg.rope_theta)
    mask = make_attention_mask(l, l, kv_valid=attn_mask, causal=causal, device=x.device)
    for p in iter_layers(params["layers"]):
        h = x + attention_block(p, cfg, rms_norm(x, p["input_norm"], cfg.rms_norm_eps),
                                cos, sin, mask)
        x = h + mlp_block(p, rms_norm(h, p["post_norm"], cfg.rms_norm_eps))
    if final_norm:
        x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return x


def embeddings_only(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup (the lyric branch feeds raw embeddings to the DiT)."""
    return params["embed_tokens"][token_ids]


def lm_logits(params: Params, cfg: QwenConfig, hidden: torch.Tensor,
              int8_act: bool = False) -> torch.Tensor:
    """Final hidden states -> vocab logits.  A serving ``lm_head`` (quantized,
    vocab padded to a multiple of 2048) is sliced back to ``vocab_size``;
    without one the embeddings are tied: bf16 operands, f32 result."""
    head = params.get("lm_head")
    if head is not None:
        logits = linear(hidden, head["kernel"], int8_act=int8_act)
        return logits[..., : cfg.vocab_size]
    emb = params["embed_tokens"]
    return torch.matmul(hidden.to(torch.bfloat16).float(),
                        emb.to(torch.bfloat16).float().t())
