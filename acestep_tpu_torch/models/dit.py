"""ACE-Step DiT denoiser (flow-matching diffusion transformer) in PyTorch: port of
the JAX package's models/dit.py, with its three condition encoders (lyric,
timbre, style projection).

Decoder layer: AdaLN from a 6-row ``scale_shift_table`` plus the timestep
projection, GQA self-attention with NEOX RoPE (every other layer a bidirectional
sliding window), cross-attention to the packed condition, SwiGLU MLP.  Dual
timestep embeddings (t and t - r), patchify via conv1d-as-linear and unpatchify
via convtranspose1d-as-linear.  Cross-attention K/V are computed once per
request (:func:`compute_all_cross_kv`) and reused by every diffusion step.
Self-attention is dense and masked below 1536 patch tokens and blocked from
there on (ops/blocked_attention.py: banded for sliding layers, flash for full
ones), in the decoder and in the encoder stacks alike.

The decoder runs on stacked layers (:func:`stack_params`) with q||k||v and
gate||up fused into one weight stream each (:func:`fuse_params`), as the JAX
engine does; every linear may carry a quantized weight.  The encoder stacks
(``lyric_layers``, ``timbre_layers``) stay lists of per-layer dicts, which
``iter_layers`` walks (the JAX ``stack_params`` stacks them for its scan; the
function is the same).

Under tensor parallelism (``group``: this rank's tp group, parallel/tp.py)
the blocks run on the rank's column shards of q/k/v and gate/up with the
local head counts, and o_proj / down_proj are row-parallel: their partial
products are summed over the group (dit.py:197-339).

Two opt-in switches of :func:`forward` stand for the JAX package's
environment knobs (dit.py:583-607, qmm.py:348-367):
  * ``dit_mega`` (``ACESTEP_TPU_DIT_MEGA=1``): at batch 1 with no
    self-attention mask, every decoder layer of the step runs in one launch of
    the Euler-step megakernel (ops/cuda/dit_mega.py) where its gate admits the
    shapes; elsewhere the layer path runs, as in the JAX package;
  * ``int8_act`` (``ACESTEP_TPU_INT8_ACT=1``): the q8_0 linears outside the
    decoder layers with at most 16 rows (the six timestep-embedding linears at
    batch 1, and proj_in / proj_out / the condition projection at such short
    lengths) take the int8-activation kernel (ops/cuda/qmm_int8.py).  The
    stacked decoder linears keep the q8_0 kernel, as the JAX package's
    ``qmm_pallas_stacked_nd`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.models.stacking import iter_layers, stack_layer_params
from acestep_tpu_torch.ops.cuda import dit_mega as _dit_mega
from acestep_tpu_torch.ops import (
    apply_rope,
    attention,
    banded_attention,
    flash_attention,
    linear,
    make_attention_mask,
    rms_norm,
    rope_cos_sin,
    silu,
    sinusoidal_timestep_embedding,
    use_blocked_attention,
)
from acestep_tpu_torch.ops.qlinear import concat_weights_n
from acestep_tpu_torch.parallel.collective_matmul import row_parallel_linear

Params = Dict[str, Any]

TIME_EMBED_IN = 256  # sinusoidal embedding width


def _silu_as(x: torch.Tensor, dtype) -> torch.Tensor:
    return silu(x.float()).to(dtype)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _self_attention(p: Params, cfg: DiTConfig, x, cos, sin, attn_fn, group=None):
    """``attn_fn(q, k, v)`` carries the masking (:func:`_make_self_attn_fns`).
    Under tensor parallelism (``group``) q/k/v are column shards, ``cfg``
    carries the local head counts (``parallel.tp.local_cfg``) and o_proj is
    row-parallel (dit.py:197-230)."""
    b, l, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    if "qkv_proj" in p:
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
    out = attn_fn(q, k, v).transpose(1, 2).reshape(b, l, nh * hd)
    return row_parallel_linear(out, p["o_proj"]["kernel"], group)


def _make_self_attn_fns(cfg: DiTConfig, seq_len: int, kv_valid, device):
    """(sliding_fn, full_fn) of the decoder / encoder stacks (dit.py:234-288).

    From the blocked-attention threshold on, sliding layers take
    :func:`banded_attention` and full layers :func:`flash_attention`, and no
    T x T mask or score tensor is built; below it both are dense masked
    attention."""
    if use_blocked_attention(seq_len):
        return (lambda q, k, v: banded_attention(q, k, v, cfg.sliding_window, kv_valid),
                lambda q, k, v: flash_attention(q, k, v, kv_valid))
    sliding_mask = make_attention_mask(seq_len, seq_len, kv_valid=kv_valid,
                                       sliding_window=cfg.sliding_window, device=device)
    full_mask = make_attention_mask(seq_len, seq_len, kv_valid=kv_valid, device=device)
    return (lambda q, k, v: attention(q, k, v, mask=sliding_mask),
            lambda q, k, v: attention(q, k, v, mask=full_mask))


def cross_kv(p: Params, cfg: DiTConfig, enc: torch.Tensor):
    """K/V [B, Hkv, Lc, D] of one layer's cross-attention over the projected
    condition [B, Lc, H]."""
    b, lc, _ = enc.shape
    hd, nkv = cfg.head_dim, cfg.num_key_value_heads
    k = linear(enc, p["k_proj"]["kernel"]).reshape(b, lc, nkv, hd)
    k = rms_norm(k, p["k_norm"], cfg.rms_norm_eps).transpose(1, 2)
    v = linear(enc, p["v_proj"]["kernel"]).reshape(b, lc, nkv, hd).transpose(1, 2)
    return k, v


def _cross_attention(p: Params, cfg: DiTConfig, x, kv, mask, group=None):
    b, l, _ = x.shape
    hd, nh = cfg.head_dim, cfg.num_attention_heads
    q = linear(x, p["q_proj"]["kernel"]).reshape(b, l, nh, hd)
    q = rms_norm(q, p["q_norm"], cfg.rms_norm_eps).transpose(1, 2)
    k, v = kv
    out = attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, l, nh * hd)
    return row_parallel_linear(out, p["o_proj"]["kernel"], group)


def _mlp(p: Params, x, group=None):
    if "gateup_proj" in p:
        gu = linear(x, p["gateup_proj"]["kernel"])
        inter = gu.shape[-1] // 2
        gate, up = gu[..., :inter], gu[..., inter:]
    else:
        gate = linear(x, p["gate_proj"]["kernel"])
        up = linear(x, p["up_proj"]["kernel"])
    return row_parallel_linear(_silu_as(gate, x.dtype) * up, p["down_proj"]["kernel"], group)


def _timestep_embed(p: Params, t: torch.Tensor, dtype, int8_act: bool = False):
    """t [B] -> (temb [B, H], proj [B, 6, H])."""
    t_freq = sinusoidal_timestep_embedding(t, TIME_EMBED_IN).to(dtype)
    temb = linear(t_freq, p["linear_1"]["kernel"], p["linear_1"]["bias"], int8_act)
    temb = linear(_silu_as(temb, dtype), p["linear_2"]["kernel"], p["linear_2"]["bias"],
                  int8_act)
    proj = linear(_silu_as(temb, dtype), p["time_proj"]["kernel"], p["time_proj"]["bias"],
                  int8_act)
    return temb, proj.reshape(proj.shape[0], 6, -1)


def compute_timestep_conditioning(params: Params, cfg: DiTConfig, timestep, timestep_r,
                                  dtype=torch.bfloat16, int8_act: bool = False):
    """Dual timestep embedding: t and (t - r)."""
    temb_t, proj_t = _timestep_embed(params["time_embed"], timestep, dtype, int8_act)
    temb_r, proj_r = _timestep_embed(params["time_embed_r"], timestep - timestep_r, dtype,
                                     int8_act)
    return temb_t + temb_r, proj_t + proj_r


def compute_condition(params: Params, cfg: DiTConfig, encoder_hidden_states,
                      int8_act: bool = False):
    """Project the packed condition once (condition_embedder)."""
    p = params["condition_embedder"]
    return linear(encoder_hidden_states, p["kernel"], p["bias"], int8_act)


def compute_all_cross_kv(params: Params, cfg: DiTConfig, enc):
    """Per-layer cross-attention K/V for a step-constant condition: a list of
    (k, v) per layer."""
    return [cross_kv(p["cross_attn"], cfg, enc) for p in iter_layers(params["layers"])]


def stack_cross_kv(kv_list) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-layer cross K/V as the megakernel reads them: (k, v) each
    [L, B, Hkv, Lc, D] in bf16 (once per request)."""
    return (torch.stack([k for k, _ in kv_list]).to(torch.bfloat16),
            torch.stack([v for _, v in kv_list]).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# layer stacking / fusion
# ---------------------------------------------------------------------------

def stack_params(params: Params) -> Params:
    """Stack the decoder layer list along a leading layer axis (idempotent)."""
    if isinstance(params.get("layers"), list):
        params = dict(params)
        params["layers"] = stack_layer_params(params["layers"])
    return params


def fuse_params(params: Params) -> Params:
    """Fuse the stacked decoder's self-attn q||k||v and mlp gate||up into one
    weight each (concat along N: exact column-for-column).  A group whose
    kernels are not all of one quant format or all plain (a small config may
    quantize only some) stays unfused.  Idempotent."""
    layers = params.get("layers")
    if not isinstance(layers, dict):
        return params
    sa, mlp = dict(layers["self_attn"]), dict(layers["mlp"])
    for group, names, fused in ((sa, ("q_proj", "k_proj", "v_proj"), "qkv_proj"),
                                (mlp, ("gate_proj", "up_proj"), "gateup_proj")):
        if names[0] not in group:
            continue
        ws = [group[n]["kernel"] for n in names]
        if len({(type(w), getattr(w, "fmt", None)) for w in ws}) == 1:
            for n in names:
                del group[n]
            group[fused] = {"kernel": concat_weights_n(ws)}
    out = dict(params)
    out["layers"] = dict(layers, self_attn=sa, mlp=mlp)
    return out


# ---------------------------------------------------------------------------
# decoder forward
# ---------------------------------------------------------------------------

def forward(
    params: Params,
    cfg: DiTConfig,
    hidden_states: torch.Tensor,             # [B, T, 64] noisy latents
    timestep: torch.Tensor,                  # [B]
    timestep_r: torch.Tensor,                # [B]
    context_latents: torch.Tensor,           # [B, T, ctx_dim]
    cross_kv_cache: List[Tuple[torch.Tensor, torch.Tensor]],
    attn_mask: Optional[torch.Tensor] = None,          # [B, T] 1=valid
    encoder_attn_mask: Optional[torch.Tensor] = None,  # [B, Lc]
    *,
    dit_mega: bool = False,
    int8_act: bool = False,
    cross_kv_stacked: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    group=None,
) -> torch.Tensor:
    """Predict the velocity v_t [B, T, 64]; ``cross_kv_cache`` comes from
    :func:`compute_all_cross_kv` on :func:`compute_condition`'s output, and
    ``cross_kv_stacked`` (optional) from :func:`stack_cross_kv` on it.
    ``dit_mega`` / ``int8_act``: the module docstring's switches.  ``group``:
    this rank's tp group under tensor parallelism (params and ``cfg`` local:
    ``parallel.tp``); the megakernel stays off then, as in dit.py:589."""
    b, t_len, _ = hidden_states.shape
    patch = cfg.patch_size
    dtype = hidden_states.dtype
    dev = hidden_states.device

    temb, timestep_proj = compute_timestep_conditioning(
        params, cfg, timestep, timestep_r, dtype, int8_act)

    x = torch.cat([context_latents.to(dtype), hidden_states], dim=-1)
    pad = (-t_len) % patch
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    tp = (t_len + pad) // patch
    x = x.reshape(b, tp, patch * cfg.in_channels)
    x = linear(x, params["proj_in"]["kernel"], params["proj_in"]["bias"], int8_act)

    cos, sin = rope_cos_sin(torch.arange(tp, device=dev), cfg.head_dim, base=cfg.rope_theta)
    cos, sin = cos.to(dtype), sin.to(dtype)

    layers = params["layers"]
    lc = cross_kv_cache[0][0].shape[2] if dit_mega else 0
    # the Euler-step megakernel (dit.py:583-607): batch 1, no self-attention
    # mask, and the kernel's gate; anything else keeps the layer path below
    if (dit_mega and group is None and b == 1 and attn_mask is None
            and _dit_mega.supported(layers, cfg, b, tp, lc)):
        if encoder_attn_mask is not None:
            encm = torch.where(encoder_attn_mask.bool(), 0.0, _dit_mega.NEG).float()
        else:
            encm = torch.zeros((1, lc), dtype=torch.float32, device=dev)
        k_stack, v_stack = cross_kv_stacked or stack_cross_kv(cross_kv_cache)
        flags = [lt == "sliding_attention" for lt in cfg.layer_types]
        x = _dit_mega.dit_layers_mega(layers, cfg, x.float(), k_stack, v_stack,
                                      timestep_proj.float(), cos.float(), sin.float(), flags,
                                      encm).to(dtype)
        return _finalize_output(params, cfg, x, temb, dtype, t_len, patch, int8_act)

    # patch-pooled self-attn validity (any valid frame in a patch -> valid patch)
    patch_valid = None
    if attn_mask is not None:
        am = F.pad(attn_mask, (0, pad)) if pad else attn_mask
        patch_valid = am.reshape(b, tp, patch).amax(dim=-1)
    attn_sliding, attn_full = _make_self_attn_fns(cfg, tp, patch_valid, dev)
    cross_mask = (make_attention_mask(tp, encoder_attn_mask.shape[1],
                                      kv_valid=encoder_attn_mask)
                  if encoder_attn_mask is not None else None)

    mod_all = timestep_proj.float()
    for li, p in enumerate(iter_layers(layers)):
        mod = p["scale_shift_table"].float()[None] + mod_all      # [B, 6, H]
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
            mod[:, j:j + 1, :].to(dtype) for j in range(6)]
        sliding = cfg.layer_types[li] == "sliding_attention"

        normed = rms_norm(x, p["self_attn_norm"], cfg.rms_norm_eps)
        normed = normed * (1.0 + scale_msa) + shift_msa
        x = x + _self_attention(p["self_attn"], cfg, normed, cos, sin,
                                attn_sliding if sliding else attn_full, group) * gate_msa

        normed = rms_norm(x, p["cross_attn_norm"], cfg.rms_norm_eps)
        x = x + _cross_attention(p["cross_attn"], cfg, normed, cross_kv_cache[li], cross_mask,
                                 group)

        normed = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        normed = normed * (1.0 + c_scale) + c_shift
        x = x + _mlp(p["mlp"], normed, group) * c_gate

    return _finalize_output(params, cfg, x, temb, dtype, t_len, patch, int8_act)


def _finalize_output(params, cfg: DiTConfig, x, temb, dtype, t_len: int, patch: int,
                     int8_act: bool = False):
    """Output AdaLN (2-row table) + unpatchify (convtranspose1d stride=patch)."""
    b, tp, _ = x.shape
    out_mod = params["out_scale_shift_table"].float()[None] + temb.float()[:, None, :]
    out_shift = out_mod[:, 0:1, :].to(dtype)
    out_scale = out_mod[:, 1:2, :].to(dtype)
    x = rms_norm(x, params["norm_out"], cfg.rms_norm_eps) * (1.0 + out_scale) + out_shift
    y = linear(x, params["proj_out"]["kernel"], int8_act=int8_act)   # [B, Tp, patch*audio]
    y = y.reshape(b, tp * patch, cfg.audio_acoustic_hidden_dim)
    y = y + params["proj_out"]["bias"].to(y.dtype)
    return y[:, :t_len, :]


# ---------------------------------------------------------------------------
# conditioning encoders
# ---------------------------------------------------------------------------

def _encoder_stack(layers, cfg: DiTConfig, x, valid, group=None):
    l = x.shape[1]
    dtype = x.dtype
    cos, sin = rope_cos_sin(torch.arange(l, device=x.device), cfg.head_dim,
                            base=cfg.rope_theta)
    cos, sin = cos.to(dtype), sin.to(dtype)
    attn_sliding, attn_full = _make_self_attn_fns(cfg, l, valid, x.device)
    for i, p in enumerate(iter_layers(layers)):
        sliding = i < len(cfg.layer_types) and cfg.layer_types[i] == "sliding_attention"
        xn = rms_norm(x, p["input_norm"], cfg.rms_norm_eps)
        x = x + _self_attention(p["self_attn"], cfg, xn, cos, sin,
                                attn_sliding if sliding else attn_full, group)
        x = x + _mlp(p["mlp"], rms_norm(x, p["post_norm"], cfg.rms_norm_eps), group)
    return x


def lyric_encoder(params: Params, cfg: DiTConfig, lyric_hidden_states,
                  lyric_mask: Optional[torch.Tensor] = None, group=None):
    """Project + encode lyric token embeddings [B, L, text_hidden] -> [B, L, H]
    (``group``: tensor parallelism, as :func:`forward`)."""
    p = params["lyric_embed"]
    x = linear(lyric_hidden_states, p["kernel"], p.get("bias"))
    x = _encoder_stack(params["lyric_layers"], cfg, x, lyric_mask, group)
    return rms_norm(x, params["lyric_norm"], cfg.rms_norm_eps)


def timbre_encoder(params: Params, cfg: DiTConfig, refer_latents,
                   refer_mask: Optional[torch.Tensor] = None, group=None):
    """Reference-audio latents [B, L, timbre_hidden] -> one timbre token
    [B, 1, H]: a linear, the special token prepended (valid in the mask), the
    encoder stack, the norm, and the first position (dit.py:748-771).  Runs
    in the latents' dtype (f32 from the engine), as the JAX function does."""
    p = params["timbre_embed"]
    x = linear(refer_latents, p["kernel"], p.get("bias"))
    special = params.get("timbre_special_token")
    if special is not None:
        tok = special.to(x.dtype)[None, None, :].expand(x.shape[0], 1, x.shape[2])
        x = torch.cat([tok, x], dim=1)
        if refer_mask is not None:
            refer_mask = torch.cat([torch.ones_like(refer_mask[:, :1]), refer_mask], dim=1)
    x = _encoder_stack(params["timbre_layers"], cfg, x, refer_mask, group)
    x = rms_norm(x, params["timbre_norm"], cfg.rms_norm_eps)
    return x[:, :1, :]


def text_projector(params: Params, style_hidden):
    """Style branch: text-encoder hidden states -> DiT hidden size."""
    return linear(style_hidden, params["text_projector"]["kernel"])
