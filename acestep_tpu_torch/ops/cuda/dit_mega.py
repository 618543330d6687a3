"""Every DiT decoder layer of one Euler step in one launch: CUDA megakernel
wrapper, its plain PyTorch version and the shape/format gate (opt-in: the JAX
package's ``ACESTEP_TPU_DIT_MEGA=1``, here ``dit.forward(..., dit_mega=True)``).

Kernel: ``csrc/dit_mega.cu`` (hand-written for sm_90a) replaces
``acestep_tpu/ops/pallas/dit_mega.py:158 _mega_kernel`` (via
``dit_layers_mega``, :381).  Per layer: AdaLN (RMSNorm and the 6-row
modulation), the fused qkv GEMM, q/k RMSNorm and NEOX rope, GQA self-attention
with the per-layer sliding band, o_proj and the gated residual, the cross
norm, cross q and attention over the cached condition K/V with the additive
encoder mask, cross o_proj and its residual, the modulated MLP input, gate-up,
SiLU(gate) * up, down and the gated residual.  The residual stream stays f32
through all layers.  The kernel is persistent and cooperative (grid from the
occupancy query; grid-wide barriers between the stages); a refused launch
raises.

Gate (``supported``): the JAX gate's shape and format rules (batch 1; q8_0
fused, stacked weights with f32 scales; every K and N a multiple of the chunk
edge ``min(H, 1024)``; head dim a multiple of 128; T a multiple of 8).  In
place of the TPU's 12 MiB VMEM budget it takes the kernel's own limits: one
attention unit in shared memory at its smallest (one query row's scores
against the longer of T and Lc, and a 32-row K / V tile: ``_smem`` within
``MAX_SMEM``) and at most ``MAX_LAYERS`` layers.  Activations and partial
sums live in device memory, so T is not capped by on-chip memory: the port
admits every case the JAX gate admits and more, for example the full-width
DiT at T = 256 patch tokens (20.48 s), which the JAX VMEM estimate declines
(16.5-17.1 MiB > 12 MiB).
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, Optional, Sequence

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.nn import rotate_half
from acestep_tpu_torch.quant import BLOCK, QuantTensor, dequantize

NEG = -1e30
CH_MAX = 1024            # the JAX gate's chunk edge: min(H, 1024)
THREADS = 256
MAXR = 8                 # attention query rows a unit (fewer where Lk is long)
MIN_TILE = 32            # K / V rows a shared-memory tile at least
ATTN_SMEM_TARGET = 96 * 1024    # q rows, scores and output sums of a unit
ATTN_SMEM = 200 * 1024          # ... and the K / V tile
MAX_SMEM = 232448        # bytes of shared memory one block may use on sm_90
GEMM_SMEM = 72704        # the GEMM tiles' shared memory (GEMM_SMEM in the .cu)
MAX_LAYERS = 512         # sliding flags travel as 8 words of bits
GEMM_TILE = 128          # GEMM output tile edge (rows and columns)
MAX_SPLIT = 8
MEGA = _build.Counted("dit_mega", "acestep_tpu_torch/csrc/dit_mega.cu",
                      "acestep_tpu/ops/pallas/dit_mega.py:158")


def _weights(layers: Dict[str, Any]):
    sa, ca, mlp = layers["self_attn"], layers["cross_attn"], layers["mlp"]
    return (sa["qkv_proj"]["kernel"], sa["o_proj"]["kernel"],
            ca["q_proj"]["kernel"], ca["o_proj"]["kernel"],
            mlp["gateup_proj"]["kernel"], mlp["down_proj"]["kernel"])


def _rows_smem(d: int, lk: int, r: int) -> int:
    """A unit's q rows, scores and output sums (f32)."""
    return (MAXR * d + r * lk + r * d) * 4


def _smem(d: int, lk: int, r: int, kt: int) -> int:
    """Dynamic shared memory of one block (mirror of smem_bytes in the .cu):
    the GEMM tiles, or an attention unit with a K / V tile of ``kt`` rows."""
    return max(GEMM_SMEM, _rows_smem(d, lk, r) + kt * (d + 2) * 2, (THREADS // 32) * d * 4)


def _attn_shape(d: int, lk: int):
    """(query rows a unit, K / V rows a tile): 8 rows unless the scores of
    that many would pass ATTN_SMEM_TARGET; then as many K / V rows as fit in
    ATTN_SMEM (all of them where they do), at least MIN_TILE."""
    r = MAXR
    while r > 1 and _rows_smem(d, lk, r) > ATTN_SMEM_TARGET:
        r //= 2
    kt = (ATTN_SMEM - _rows_smem(d, lk, r)) // ((d + 2) * 2)
    return r, max(MIN_TILE, min(lk, kt))


def supported(layers: Dict[str, Any], cfg, b: int, t: int, lc: int) -> bool:
    """Shape/format gate; anything outside keeps the layer path."""
    if b != 1:
        return False
    h = cfg.hidden_size
    ch = h if h <= CH_MAX else CH_MAX
    qdim = cfg.num_attention_heads * cfg.head_dim
    kvdim = cfg.num_key_value_heads * cfg.head_dim
    try:
        ws = _weights(layers)
    except (KeyError, TypeError):
        return False
    for qt in ws:
        if not isinstance(qt, QuantTensor) or qt.fmt != "q8_0" or not qt.stacked:
            return False
        if qt.scales.dtype != torch.float32:
            return False
        k, n = qt.shape
        if k % ch or n % ch:
            return False
    if h % ch or (qdim + 2 * kvdim) % ch or cfg.intermediate_size % ch:
        return False
    if cfg.head_dim % 128 or t % 8 or t < 8:
        return False
    if ws[0].num_layers > MAX_LAYERS:
        return False
    return _smem(cfg.head_dim, max(t, lc), 1, MIN_TILE) <= MAX_SMEM


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _rms(x, w, eps):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.float()


def _bf(x):
    return x.to(torch.bfloat16).float()


def _attend(q, k, v, add, inv_sqrt_d):
    """q [Hq, T, D], k / v [Hkv, Lk, D] (bf16 values), add [T | 1, Lk] ->
    [T, Hq * D] f32: f32 scores, e / sum(e), p rounded to bf16."""
    grp = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(grp, 0), v.repeat_interleave(grp, 0)
    s = (q @ k.transpose(-1, -2)) * inv_sqrt_d + add
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = _bf(e / e.sum(-1, keepdim=True))
    o = p @ v
    return o.transpose(0, 1).reshape(q.shape[1], -1)


def _inputs(layers, x, k_stack, v_stack, timestep_proj):
    n_layers = _weights(layers)[0].num_layers
    hkv, lc, d = k_stack.shape[-3:]
    t, h = x.shape[-2:]
    return (n_layers, t, h, hkv, lc, d,
            k_stack.reshape(n_layers, hkv, lc, d), v_stack.reshape(n_layers, hkv, lc, d),
            timestep_proj.reshape(6, h).float())


def dit_layers_mega_plain(layers, cfg, x, k_stack, v_stack, timestep_proj, cos, sin,
                          sliding_flags: Sequence, enc_mask_add):
    """The megakernel's function in plain PyTorch, rounding point for rounding
    point: x [1, T, H] -> [1, T, H] f32.  ``k_stack`` / ``v_stack`` [L, Hkv, Lc,
    D] (or [L, 1, Hkv, Lc, D]); ``timestep_proj`` [1, 6, H]; ``cos`` / ``sin``
    [T, D]; ``enc_mask_add`` [1, Lc] additive (0 / -1e30)."""
    n_layers, t, h, hkv, lc, d, ks, vs, tproj = _inputs(layers, x, k_stack, v_stack,
                                                        timestep_proj)
    hq, inter, eps = cfg.num_attention_heads, cfg.intermediate_size, cfg.rms_norm_eps
    qdim, kvdim = hq * d, hkv * d
    inv_sqrt_d = 1.0 / math.sqrt(d)
    sa, ca = layers["self_attn"], layers["cross_attn"]
    wqkv, wso, wcq, wco, wgu, wdn = _weights(layers)
    cos, sin = cos.float()[:, None, :], sin.float()[:, None, :]
    pos = torch.arange(t, device=x.device)
    band = torch.where((pos[:, None] - pos[None, :]).abs() <= cfg.sliding_window, 0.0, NEG)
    no_mask = torch.zeros_like(band)
    encm = enc_mask_add.reshape(1, lc).float()

    def mm(a, w, li):
        return a @ dequantize(w.layer(li), torch.bfloat16).float()

    x = x.reshape(t, h).float()
    for li in range(n_layers):
        mod = layers["scale_shift_table"][li].float() + tproj            # [6, H]
        xa = _bf(_rms(x, layers["self_attn_norm"][li], eps) * (1.0 + mod[1]) + mod[0])
        qkv = mm(xa, wqkv, li)
        q = _rms(qkv[:, :qdim].reshape(t, hq, d), sa["q_norm"][li], eps)
        k = _rms(qkv[:, qdim:qdim + kvdim].reshape(t, hkv, d), sa["k_norm"][li], eps)
        v = qkv[:, qdim + kvdim:].reshape(t, hkv, d)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        o = _attend(_bf(q).transpose(0, 1), _bf(k).transpose(0, 1), _bf(v).transpose(0, 1),
                    band if sliding_flags[li] else no_mask, inv_sqrt_d)
        x = x + mm(_bf(o), wso, li) * mod[2]
        xa = _bf(_rms(x, layers["cross_attn_norm"][li], eps))
        q = _bf(_rms(mm(xa, wcq, li).reshape(t, hq, d), ca["q_norm"][li], eps))
        o = _attend(q.transpose(0, 1), ks[li].float(), vs[li].float(), encm, inv_sqrt_d)
        x = x + mm(_bf(o), wco, li)
        xa = _bf(_rms(x, layers["mlp_norm"][li], eps) * (1.0 + mod[4]) + mod[3])
        gu = mm(xa, wgu, li)
        g, u = gu[:, :inter], gu[:, inter:]
        x = x + mm(_bf(g * torch.sigmoid(g) * u), wdn, li) * mod[5]
    return x[None]


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _contig(t, dtype, dev, name):
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"dit_mega: {name} must be a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} on {t.device}")
    return t


def split_k(grid: int, t: int, k: int, n: int) -> int:
    """Split-K count of one GEMM: enough units to fill the grid, at least four
    32-row blocks a split, at most MAX_SPLIT; every split non-empty."""
    tiles = -(-t // GEMM_TILE) * -(-n // GEMM_TILE)
    nkb = k // BLOCK
    s = max(1, min(grid // tiles, nkb // 4, MAX_SPLIT))
    per = -(-nkb // s)
    return -(-nkb // per)


STAGES = ("qkv", "heads", "self-attn", "o_proj", "rows (self)", "cross q", "cross-attn",
          "cross o_proj", "rows (cross)", "gate-up", "act", "down", "rows (mlp)")


def stage_times(stamps: torch.Tensor, n_layers: int) -> Dict[str, float]:
    """ms per launch by stage (summed over the layers) from the ``stamps``
    (int64 [2 + 13 L]) of one launch; "init" is the first AdaLN.  Each stage's
    time runs to the grid barrier after it."""
    t = stamps.cpu().double() / 1e6
    n = len(STAGES)
    out = {"init": float(t[1] - t[0])}
    for s_i, name in enumerate(STAGES):
        out[name] = sum(float(t[2 + n * li + s_i] - t[1 + n * li + s_i])
                        for li in range(n_layers))
    return out


def dit_layers_mega(layers, cfg, x, k_stack, v_stack, timestep_proj, cos, sin,
                    sliding_flags: Sequence, enc_mask_add, grid: int = 0,
                    stamps: Optional[torch.Tensor] = None):
    """Every decoder layer of one Euler step -> x [1, T, H] f32 (arguments as
    :func:`dit_layers_mega_plain`).  The caller checks :func:`supported`
    first; ``grid`` overrides the cooperative grid (0: from the occupancy
    query); ``stamps`` (int64 [2 + 13 L] on the card) receives the card's
    clock in ns at the launch's start, after the first AdaLN and after each
    of the 13 stages of every layer (:func:`stage_times` reads them)."""
    if x.device.type == "cpu":
        return dit_layers_mega_plain(layers, cfg, x, k_stack, v_stack, timestep_proj, cos,
                                     sin, sliding_flags, enc_mask_add)
    if x.device.type != "cuda":
        raise ValueError(f"dit_mega: unsupported device {x.device}")
    n_layers, t, h, hkv, lc, d, ks, vs, tproj = _inputs(layers, x, k_stack, v_stack,
                                                        timestep_proj)
    if x.shape[0] != 1 or not supported(layers, cfg, 1, t, lc):
        raise ValueError(f"dit_mega: B={x.shape[0]} T={t} Lc={lc} outside the kernel's gate")
    if len(sliding_flags) != n_layers or hkv != cfg.num_key_value_heads:
        raise ValueError("dit_mega: sliding flags or cross K/V do not match the layers")
    dev = x.device
    hq, inter = cfg.num_attention_heads, cfg.intermediate_size
    qdim = hq * d
    ptrs = []
    for qt, (k, n) in zip(_weights(layers), ((h, qdim + 2 * hkv * d), (qdim, h), (h, qdim),
                                             (qdim, h), (h, 2 * inter), (inter, h))):
        if tuple(qt.shape) != (k, n) or tuple(qt.data.shape) != (n_layers, k, n):
            raise ValueError(f"dit_mega: weight {tuple(qt.data.shape)} where "
                             f"({n_layers}, {k}, {n}) is expected")
        ptrs += [_contig(qt.data, torch.int8, dev, "weight data").data_ptr(),
                 _contig(qt.scales, torch.float32, dev, "weight scales").data_ptr()]
    sa, ca = layers["self_attn"], layers["cross_attn"]
    small = [layers["self_attn_norm"], layers["cross_attn_norm"], layers["mlp_norm"],
             layers["scale_shift_table"], sa["q_norm"], sa["k_norm"], ca["q_norm"]]
    small_f32 = not all(s.dtype == torch.bfloat16 for s in small)
    small = [(s.float() if small_f32 else s).contiguous() for s in small]
    for s, shape in zip(small, ((n_layers, h),) * 3 + ((n_layers, 6, h),) + ((n_layers, d),) * 3):
        if tuple(s.shape) != shape or s.device != dev:
            raise ValueError(f"dit_mega: layer tensor {tuple(s.shape)} on {s.device} where "
                             f"{shape} on {dev} is expected")
    ks, vs = ks.to(torch.bfloat16).contiguous(), vs.to(torch.bfloat16).contiguous()
    x0 = x.reshape(t, h).float().contiguous()
    tproj = tproj.contiguous()
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    encm = enc_mask_add.reshape(lc).float().contiguous()
    for name, a, shape in (("cos", cos, (t, d)), ("sin", sin, (t, d))):
        if tuple(a.shape) != shape:
            raise ValueError(f"dit_mega: {name} {tuple(a.shape)} where {shape} is expected")
    lk = max(t, lc)
    r, kt = _attn_shape(d, lk)
    lib = _build.lib()
    if grid <= 0:
        grid = lib.acestep_dit_mega_grid(lib.acestep_dit_mega_smem(d, lk, r, kt))
        if grid <= 0:
            raise RuntimeError(f"dit_mega: occupancy query gave {grid} blocks")
    gemms = ((h, qdim + 2 * hkv * d), (qdim, h), (h, qdim), (qdim, h), (h, 2 * inter),
             (inter, h))
    splits = [split_k(grid, t, k, n) for k, n in gemms]
    out = torch.empty((t, h), dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    scratch = [torch.empty(n, dtype=bf, device=dev)
               for n in (t * h, hq * t * d, hkv * t * d, hkv * t * d, t * qdim, t * inter)]
    part = torch.empty(max(s * t * n for s, (_, n) in zip(splits, gemms)),
                       dtype=torch.float32, device=dev)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    ptrs += [a.data_ptr() for a in small]
    ptrs += [a.data_ptr() for a in (ks, vs, x0, tproj, cos, sin, encm, out)]
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device != dev
                               or stamps.numel() < 2 + len(STAGES) * n_layers):
        raise ValueError(f"dit_mega: stamps must be int64 [{2 + len(STAGES) * n_layers}] "
                         f"on {dev}")
    ptrs += [a.data_ptr() for a in scratch] + [part.data_ptr(), sync.data_ptr(),
                                                None if stamps is None else stamps.data_ptr()]
    dims = [n_layers, t, h, hq, hkv, d, inter, lc, cfg.sliding_window, r, int(small_f32),
            *splits, kt]
    words = [0] * 8
    for li, f in enumerate(sliding_flags):
        if f:
            words[li // 64] |= 1 << (li % 64)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_flags = (ctypes.c_uint64 * 8)(*words)
    err = lib.acestep_dit_mega(
        ctypes.cast(c_ptrs, ctypes.c_void_p), ctypes.cast(c_dims, ctypes.c_void_p),
        ctypes.cast(c_flags, ctypes.c_void_p), float(cfg.rms_norm_eps),
        float(1.0 / math.sqrt(d)), int(grid), _build.stream_ptr(x))
    _build.check("acestep_dit_mega", err)
    MEGA.count((t, lc))
    return out[None]
