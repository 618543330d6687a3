"""Single-token decode attention over the stacked int8 KV cache: CUDA kernel
wrappers and their plain PyTorch versions (the LM decode layer scan with
``decode_attn="pallas"`` or ``"fused"``, serving/lm.py).

Kernels: ``csrc/decode_attn.cu`` (hand-written for sm_90a).
  * ``decode_attention_int8_stacked`` replaces
    ``acestep_tpu/ops/pallas/decode_attn.py:57 _kernel`` (via
    ``decode_attention_int8_stacked``, :334): GQA attention of the current
    token over layer ``li`` of the cache, per-vector scales folded in, online
    softmax seeded with the unquantized self term, only the valid T blocks read.
  * ``decode_attention_fused_stacked`` replaces ``decode_attn.py:145
    _fused_kernel`` (via ``decode_attention_fused_stacked``, :220): the same
    with the q/k RMSNorm, NEOX rope and int8 quantization of the new K/V in
    front.

The cache is walked in blocks of ``tb`` positions (the largest of 1024, 512,
256, 128 that divides T), as the Pallas grid does, so both versions round the
probabilities against the same running max.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  Shapes the kernels do
not take (head dim other than 128, T not a multiple of 128, more than 8 query
heads per kv head) return None, and the caller keeps the plain layer scan, as
the JAX entry points do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.nn import rotate_half
from acestep_tpu_torch.quant.kv import quantize_kv

NEG_INF = -1e30
HEAD_DIM = 128
MAX_GROUP = 8
SOURCE = "acestep_tpu_torch/csrc/decode_attn.cu"
ATTN = _build.Counted("decode_attn", SOURCE, "acestep_tpu/ops/pallas/decode_attn.py:57")
FUSED = _build.Counted("decode_attn_fused", SOURCE,
                       "acestep_tpu/ops/pallas/decode_attn.py:145")


def pick_tb(t_max: int) -> Optional[int]:
    for tb in (1024, 512, 256, 128):
        if t_max % tb == 0:
            return tb
    return None


def takes(hq: int, hkv: int, d: int, t_max: int) -> bool:
    return (d == HEAD_DIM and hkv > 0 and hq % hkv == 0 and hq // hkv <= MAX_GROUP
            and pick_tb(t_max) is not None)


def _online_attention(qb, kc_l, ksc_l, vc_l, vsc_l, lengths, k_self, v_self, tb):
    """The kernels' attention in plain PyTorch.  qb [B, Hkv, G, D] bf16-valued
    f32; cache slices [B, Hkv, T(, D)]; k_self / v_self [B, Hkv, D] f32."""
    b, hkv, g, d = qb.shape
    t_max = kc_l.shape[2]
    sm_scale = 1.0 / math.sqrt(d)
    m = (qb * k_self[:, :, None, :]).sum(-1) * sm_scale          # [B, Hkv, G]
    l = torch.ones_like(m)
    acc = v_self[:, :, None, :].expand(b, hkv, g, d).clone()
    lengths = lengths.to(device=qb.device, dtype=torch.int64)
    # blocks past a row's last valid one are fully masked: exp(-1e30 - m) = 0
    # and alpha = 1, so running them changes nothing
    for t0 in range(0, t_max, tb):
        k = kc_l[:, :, t0:t0 + tb].float()
        s = torch.einsum("bhgd,bhtd->bhgt", qb, k) * sm_scale
        s = s * ksc_l[:, :, None, t0:t0 + tb]
        pos = t0 + torch.arange(tb, device=qb.device)
        s = torch.where(pos[None, None, None, :] < lengths[:, None, None, None], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = (p * vsc_l[:, :, None, t0:t0 + tb]).to(torch.bfloat16).float()
        o = torch.einsum("bhgt,bhtd->bhgd", pv, vc_l[:, :, t0:t0 + tb].float())
        acc = acc * alpha[..., None] + o
        m = m_new
    return (acc / l[..., None]).reshape(b, hkv * g, d)


def decode_attention_plain(q, kc, ksc, vc, vsc, lengths, li: int, k_self, v_self):
    """Row 9's function in plain PyTorch -> [B, Hq, D] f32."""
    b, hq, d = q.shape
    hkv = kc.shape[2]
    qb = q.to(torch.bfloat16).float().reshape(b, hkv, hq // hkv, d)
    return _online_attention(qb, kc[li], ksc[li], vc[li], vsc[li], lengths,
                             k_self.to(torch.bfloat16).float(),
                             v_self.to(torch.bfloat16).float(), pick_tb(kc.shape[3]))


def rms_norm_rope(x, w, cos, sin, eps):
    """q/k RMSNorm rounded to bf16, then NEOX rope rounded to bf16 (the fused
    kernel's prologue).  x [B, H, D]; cos / sin [B, D] f32."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * w.float()).to(torch.bfloat16).float()
    return (y * cos[:, None] + rotate_half(y) * sin[:, None]).to(torch.bfloat16)


def decode_attention_fused_plain(q_raw, k_raw, v_raw, q_norm, k_norm, cos, sin,
                                 kc, ksc, vc, vsc, lengths, li: int, eps: float = 1e-6):
    """Row 10's function in plain PyTorch -> (out [B, Hq, D] f32, k_new
    [B, Hkv, D] int8, k_scale [B, Hkv] f32, v_new, v_scale)."""
    b, hq, d = q_raw.shape
    hkv = kc.shape[2]
    q = rms_norm_rope(q_raw.to(torch.bfloat16), q_norm, cos.float(), sin.float(), eps)
    k = rms_norm_rope(k_raw.to(torch.bfloat16), k_norm, cos.float(), sin.float(), eps)
    v = v_raw.to(torch.bfloat16).float()
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    qb = q.float().reshape(b, hkv, hq // hkv, d)
    out = _online_attention(qb, kc[li], ksc[li], vc[li], vsc[li], lengths, k.float(), v,
                            pick_tb(kc.shape[3]))
    return out, kq, ks, vq, vs


def _check_cache(kc, ksc, vc, vsc, lengths, dev, b):
    n_l, bc, hkv, t_max, d = kc.shape
    for name, a, dtype, shape in (("kc", kc, torch.int8, kc.shape),
                                  ("vc", vc, torch.int8, kc.shape),
                                  ("ksc", ksc, torch.float32, kc.shape[:4]),
                                  ("vsc", vsc, torch.float32, kc.shape[:4]),
                                  ("lengths", lengths, torch.int32, (b,))):
        if a.dtype != dtype or tuple(a.shape) != tuple(shape) or not a.is_contiguous() \
                or a.device != dev:
            raise ValueError(f"decode attention: {name} must be a contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")
    if bc != b:
        raise ValueError(f"decode attention: cache batch {bc} != query batch {b}")


def _bf16(x):
    return x.to(torch.bfloat16).contiguous()


def _f32(x):
    return x.to(torch.float32).contiguous()


def decode_attention_int8_stacked(q, kc, ksc, vc, vsc, lengths, li: int, k_self, v_self):
    """Single-token GQA attention for layer ``li`` -> [B, Hq, D] f32, or None
    for shapes the kernel does not take."""
    b, hq, d = q.shape
    n_l, _, hkv, t_max, _ = kc.shape
    if not takes(hq, hkv, d, t_max):
        return None
    if q.device.type == "cpu":
        return decode_attention_plain(q, kc, ksc, vc, vsc, lengths, li, k_self, v_self)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q.device}")
    _check_cache(kc, ksc, vc, vsc, lengths, q.device, b)
    if not 0 <= li < n_l:
        raise ValueError(f"decode attention: layer {li} of {n_l}")
    q, k_self, v_self = _bf16(q), _bf16(k_self), _bf16(v_self)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=q.device)
    tb = pick_tb(t_max)
    err = _build.lib().acestep_decode_attn(
        q.data_ptr(), kc.data_ptr(), ksc.data_ptr(), vc.data_ptr(), vsc.data_ptr(),
        lengths.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), out.data_ptr(),
        b, hq, hkv, t_max, li, tb, _build.stream_ptr(q))
    _build.check("acestep_decode_attn", err)
    ATTN.count((b, hq, hkv, t_max))
    return out


def decode_attention_fused_stacked(q_raw, k_raw, v_raw, q_norm, k_norm, cos, sin,
                                   kc, ksc, vc, vsc, lengths, li: int, eps: float = 1e-6):
    """q/k norm + rope + KV quantize + attention for layer ``li`` -> (out
    [B, Hq, D] f32, k_new [B, Hkv, D] int8, k_scale [B, Hkv], v_new, v_scale),
    or None for shapes the kernel does not take."""
    b, hq, d = q_raw.shape
    n_l, _, hkv, t_max, _ = kc.shape
    if not takes(hq, hkv, d, t_max):
        return None
    if q_raw.device.type == "cpu":
        return decode_attention_fused_plain(q_raw, k_raw, v_raw, q_norm, k_norm, cos, sin,
                                            kc, ksc, vc, vsc, lengths, li, eps)
    if q_raw.device.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {q_raw.device}")
    _check_cache(kc, ksc, vc, vsc, lengths, q_raw.device, b)
    if not 0 <= li < n_l:
        raise ValueError(f"decode attention: layer {li} of {n_l}")
    dev = q_raw.device
    q_raw, k_raw, v_raw = _bf16(q_raw), _bf16(k_raw), _bf16(v_raw)
    q_norm, k_norm, cos, sin = _f32(q_norm), _f32(k_norm), _f32(cos), _f32(sin)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    k_new = torch.empty((b, hkv, d), dtype=torch.int8, device=dev)
    v_new = torch.empty((b, hkv, d), dtype=torch.int8, device=dev)
    ks_new = torch.empty((b, hkv), dtype=torch.float32, device=dev)
    vs_new = torch.empty((b, hkv), dtype=torch.float32, device=dev)
    tb = pick_tb(t_max)
    err = _build.lib().acestep_decode_attn_fused(
        q_raw.data_ptr(), k_raw.data_ptr(), v_raw.data_ptr(), q_norm.data_ptr(),
        k_norm.data_ptr(), cos.data_ptr(), sin.data_ptr(), kc.data_ptr(), ksc.data_ptr(),
        vc.data_ptr(), vsc.data_ptr(), lengths.data_ptr(), out.data_ptr(), k_new.data_ptr(),
        ks_new.data_ptr(), v_new.data_ptr(), vs_new.data_ptr(), b, hq, hkv, t_max, li, tb,
        float(eps), _build.stream_ptr(q_raw))
    _build.check("acestep_decode_attn_fused", err)
    FUSED.count((b, hq, hkv, t_max))
    return out, k_new, ks_new, v_new, vs_new
