"""Whole-model LM decode step in one launch: CUDA megakernel wrapper, its plain
PyTorch version and the shape/format gate (the default decode step on the
card, serving/lm.py ``decode_mega="auto"``).

Kernel: ``csrc/decode_mega.cu`` (hand-written for sm_90a) replaces
``acestep_tpu/ops/pallas/decode_mega.py:131 _mega_kernel`` (via
``decode_layers_mega``, :357).  It runs every layer of one decode step for the
serving-fused q8_0 weights: RMSNorm, qkv, q/k RMSNorm, NEOX rope, int8
quantization of the new K/V, GQA attention over the int8 cache with the
current token's self term, o_proj, post-norm, gate-up, SiLU, down_proj, with
the residual rounded to bf16 after each add.  The cache is read without the
current token; the caller writes the returned K/V rows at ``length``.

The kernel is persistent and cooperative (``cudaLaunchCooperativeKernel``,
grid from the occupancy query, so every block is resident and the grid-wide
barriers between stages cannot deadlock); a refused launch raises.

Gate (``supported``): the JAX gate's shape and format rules (q8_0 fused
weights, every K and N a multiple of 1024, hidden 1024, B <= 8, T a multiple
of 128) plus the kernel's own limits instead of the TPU VMEM budget: head dim
128 and at most 4 query heads per kv head (one attention unit's registers and
shared memory), and the launch's device scratch under MAX_SCRATCH bytes.  The
TPU kernel kept the f32 scores of every position in VMEM, which capped T; here
the scores and each 128-position chunk's softmax and P.V shares go to device
memory (L2-resident at serving sizes), so T is bounded by that scratch alone:
~2 x B x Hq x T f32, 1.4 MB at B = 8, T = 1408.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.nn import rotate_half
from acestep_tpu_torch.quant import BLOCK, QuantTensor, dequantize
from acestep_tpu_torch.quant.kv import quantize_kv

CH = 1024          # the JAX gate's weight-chunk edge: every K and N a multiple
TC = 128           # cache T granularity (and the kernel's attention chunk)
MAX_B = 8
MAX_GROUP = 4
HEAD_DIM = 128
TILE = 128
MAX_SCRATCH = 256 * 2**20   # bytes of device scratch one launch may take
SYNC_COUNTERS = 1024        # column tiles of qkv + o + gate-up + down (96 at 0.6B)
NEG = -1e30
MEGA = _build.Counted("decode_mega", "acestep_tpu_torch/csrc/decode_mega.cu",
                      "acestep_tpu/ops/pallas/decode_mega.py:131")


def scratch_floats(b: int, h: int, hq: int, hkv: int, inter: int, t_max: int) -> int:
    """f32 scratch of one launch (mirror of scratch_layout in the .cu)."""
    d, nch = HEAD_DIM, t_max // TC
    qdim, nqkv = hq * d, hq * d + 2 * hkv * d
    part = max((h // TILE) * nqkv, (qdim // TILE) * h, (h // TILE) * 2 * inter,
               (inter // TILE) * h)
    return b * (qdim + 2 * hkv * d + hq * t_max + 2 * hq * nch + hq * nch * d + 2 * hq
                + 2 * inter + part)


def _weights(layers):
    return (layers["qkv_proj"]["kernel"], layers["o_proj"]["kernel"],
            layers["gateup_proj"]["kernel"], layers["down_proj"]["kernel"])


def supported(layers: Dict[str, Any], cfg, b: int, t_max: int) -> bool:
    """Shape/format gate for the megakernel path."""
    try:
        ws = _weights(layers)
    except (KeyError, TypeError):
        return False
    for qt in ws:
        if not isinstance(qt, QuantTensor) or qt.fmt != "q8_0" or not qt.stacked:
            return False
        if qt.scales.dtype not in (torch.float32, torch.float16):
            return False
        k, n = qt.shape
        if k % CH or n % CH:
            return False
    if cfg.hidden_size != CH or cfg.head_dim != HEAD_DIM:
        return False
    nkv = cfg.num_key_value_heads
    if nkv == 0 or cfg.num_attention_heads % nkv or cfg.num_attention_heads // nkv > MAX_GROUP:
        return False
    if b > MAX_B or t_max % TC:
        return False
    hq_cols = (cfg.num_attention_heads + 2 * nkv) * HEAD_DIM
    if (hq_cols + 2 * cfg.hidden_size + 2 * cfg.intermediate_size) // TILE > SYNC_COUNTERS:
        return False
    return 4 * scratch_floats(b, cfg.hidden_size, cfg.num_attention_heads, nkv,
                              cfg.intermediate_size, t_max) <= MAX_SCRATCH


def _rms(x, w, eps):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.float()


def _bf(x):
    return x.to(torch.bfloat16).float()


def decode_layers_mega_plain(layers, cfg, cache_k, cache_ks, cache_v, cache_vs, lengths,
                             x0, cos, sin):
    """The megakernel's function in plain PyTorch, rounding point for rounding
    point -> (x [B, H] f32, k_new [L, B, Hkv, D] int8, ks_new [L, B, Hkv] f32,
    v_new, vs_new)."""
    n_layers, _, hkv, t_max, d = cache_k.shape
    b = x0.shape[0]
    hq = cfg.num_attention_heads
    g = hq // hkv
    qdim, kvdim, inter = hq * d, hkv * d, cfg.intermediate_size
    eps = cfg.rms_norm_eps
    inv_sqrt_d = 1.0 / math.sqrt(d)
    wqkv, wo, wgu, wdn = _weights(layers)
    cos = cos.float()[:, None, :]
    sin = sin.float()[:, None, :]
    valid = torch.arange(t_max, device=x0.device)[None, :] < lengths.to(x0.device)[:, None]
    valid = valid[:, None, None, :]
    x = x0.float()
    outs = []
    for li in range(n_layers):
        xnb = _bf(_rms(x, layers["input_norm"][li], eps))
        qkv = xnb @ dequantize(wqkv.layer(li), torch.bfloat16).float()
        q = qkv[:, :qdim].reshape(b, hq, d)
        k = qkv[:, qdim:qdim + kvdim].reshape(b, hkv, d)
        v = qkv[:, qdim + kvdim:].reshape(b, hkv, d)
        q = _rms(q, layers["q_norm"][li], eps)
        k = _rms(k, layers["k_norm"][li], eps)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        kq8, ksc = quantize_kv(k)
        vq8, vsc = quantize_kv(v)
        outs.append((kq8, ksc, vq8, vsc))
        qg = q.reshape(b, hkv, g, d)
        s = torch.einsum("bhgd,bhtd->bhgt", _bf(qg), cache_k[li].float())
        s = s * inv_sqrt_d * cache_ks[li][:, :, None, :]
        sb = torch.where(valid, s, torch.full_like(s, NEG))
        s_self = (qg * k[:, :, None, :]).sum(-1) * inv_sqrt_d         # [B, Hkv, G]
        m = torch.maximum(sb.amax(-1), s_self)
        e = torch.where(valid, torch.exp(sb - m[..., None]), torch.zeros_like(sb))
        e_self = torch.exp(s_self - m)
        denom = e.sum(-1) + e_self
        p = _bf(e * cache_vs[li][:, :, None, :])
        o = torch.einsum("bhgt,bhtd->bhgd", p, cache_v[li].float())
        o = (o + e_self[..., None] * v[:, :, None, :]) / denom[..., None]
        y = _bf(o.reshape(b, qdim)) @ dequantize(wo.layer(li), torch.bfloat16).float()
        x = _bf(x + y)
        hn = _bf(_rms(x, layers["post_norm"][li], eps))
        gu = hn @ dequantize(wgu.layer(li), torch.bfloat16).float()
        gate, up = gu[:, :inter], gu[:, inter:]
        act = _bf(_bf(gate * torch.sigmoid(gate)) * _bf(up))
        x = _bf(x + act @ dequantize(wdn.layer(li), torch.bfloat16).float())
    k_new, ks_new, v_new, vs_new = (torch.stack([o[i] for o in outs]) for i in range(4))
    return x, k_new, ks_new, v_new, vs_new


STAGES = ("rms+qkv+heads", "scores", "softmax+pv", "o_proj", "norm+gate_up", "down")


def stage_times(stamps: torch.Tensor, n_layers: int) -> Dict[str, float]:
    """ms per launch by stage (summed over the layers) from the ``stamps``
    (int64 [2 + 6 L]) of one launch; "setup" is the residual copy before the
    first layer.  Each stage's time runs to the grid barrier after it."""
    t = stamps.cpu().double() / 1e6
    n = len(STAGES)
    out = {"setup": float(t[1] - t[0])}
    for s_i, name in enumerate(STAGES):
        out[name] = sum(float(t[2 + n * li + s_i] - t[1 + n * li + s_i])
                        for li in range(n_layers))
    return out


def _contig(t, dtype, dev, name):
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"decode_mega: {name} must be a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} on {t.device}")
    return t


def decode_layers_mega(layers, cfg, cache_k, cache_ks, cache_v, cache_vs, lengths,
                       x0, cos, sin, grid: int = 0, stamps: Optional[torch.Tensor] = None):
    """Every layer of one decode step -> (x [B, H] f32, k_new [L, B, Hkv, D]
    int8, ks_new [L, B, Hkv] f32, v_new, vs_new).  The caller checks
    :func:`supported` first; ``grid`` overrides the cooperative grid (0: from
    the occupancy query); ``stamps`` (int64 [2 + 6 L] on the card) receives the
    card's clock in ns at the launch's start and after the set-up and each of
    the 6 stages of every layer (:func:`stage_times` reads them)."""
    if x0.device.type == "cpu":
        return decode_layers_mega_plain(layers, cfg, cache_k, cache_ks, cache_v, cache_vs,
                                        lengths, x0, cos, sin)
    if x0.device.type != "cuda":
        raise ValueError(f"decode_mega: unsupported device {x0.device}")
    n_layers, bc, hkv, t_max, d = cache_k.shape
    b, h = x0.shape
    if not supported(layers, cfg, b, t_max) or bc != b:
        raise ValueError(f"decode_mega: B={b} (cache {bc}) T={t_max} outside the kernel's gate")
    dev = x0.device
    wqkv, wo, wgu, wdn = _weights(layers)
    f16 = wqkv.scales.dtype == torch.float16
    sdt = torch.float16 if f16 else torch.float32
    ptrs = []
    for name, qt in (("qkv_proj", wqkv), ("o_proj", wo), ("gateup_proj", wgu),
                     ("down_proj", wdn)):
        k, n = qt.shape
        _contig(qt.data, torch.int8, dev, f"{name} data")
        _contig(qt.scales, sdt, dev, f"{name} scales")
        if tuple(qt.data.shape) != (n_layers, k, n) or \
                tuple(qt.scales.shape) != (n_layers, k // BLOCK, n):
            raise ValueError(f"decode_mega: {name} fields {tuple(qt.data.shape)} / "
                             f"{tuple(qt.scales.shape)} for {n_layers} layers of ({k}, {n})")
        ptrs += [qt.data.data_ptr(), qt.scales.data_ptr()]
    norms = [_contig(layers[nm].float().contiguous(), torch.float32, dev, nm)
             for nm in ("input_norm", "post_norm", "q_norm", "k_norm")]
    for name, a, dtype in (("cache_k", cache_k, torch.int8), ("cache_v", cache_v, torch.int8),
                           ("cache_ks", cache_ks, torch.float32),
                           ("cache_vs", cache_vs, torch.float32),
                           ("lengths", lengths, torch.int32)):
        _contig(a, dtype, dev, name)
    x0 = x0.float().contiguous()
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    hq, inter = cfg.num_attention_heads, cfg.intermediate_size
    lib = _build.lib()
    x = torch.empty((b, h), dtype=torch.float32, device=dev)
    k_new = torch.empty((n_layers, b, hkv, d), dtype=torch.int8, device=dev)
    v_new = torch.empty_like(k_new)
    ks_new = torch.empty((n_layers, b, hkv), dtype=torch.float32, device=dev)
    vs_new = torch.empty_like(ks_new)
    scratch = torch.empty(lib.acestep_decode_mega_scratch(b, h, hq, hkv, inter, t_max),
                          dtype=torch.float32, device=dev)
    # the grid barrier's arrival counter and generation word, and the
    # per-column-tile arrival counters of the split-K reductions
    sync = torch.zeros(2 + SYNC_COUNTERS, dtype=torch.int32, device=dev)
    err = lib.acestep_decode_mega(
        *ptrs, int(f16), *(t.data_ptr() for t in norms), cache_k.data_ptr(),
        cache_ks.data_ptr(), cache_v.data_ptr(), cache_vs.data_ptr(), lengths.data_ptr(),
        x0.data_ptr(), cos.data_ptr(), sin.data_ptr(), x.data_ptr(), k_new.data_ptr(),
        ks_new.data_ptr(), v_new.data_ptr(), vs_new.data_ptr(), scratch.data_ptr(),
        sync.data_ptr(), None if stamps is None else stamps.data_ptr(),
        n_layers, b, h, hq, hkv, inter, t_max,
        float(cfg.rms_norm_eps), int(grid), _build.stream_ptr(x0))
    _build.check("acestep_decode_mega", err)
    MEGA.count((b, t_max))
    return x, k_new, ks_new, v_new, vs_new
