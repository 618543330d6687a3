"""Whole-model LM decode step in one launch: CUDA megakernel wrapper, its plain
PyTorch version, the shape/format gate and the kernel's plan (the default
decode step on the card, serving/lm.py ``decode_mega="auto"``).

Kernel: ``csrc/decode_mega.cu`` (hand-written for sm_90a) replaces
``acestep_tpu/ops/pallas/decode_mega.py:131 _mega_kernel`` (via
``decode_layers_mega``, :357).  It runs every layer of one decode step for the
serving-fused q8_0 weights: RMSNorm, qkv, q/k RMSNorm, NEOX rope, int8
quantization of the new K/V, GQA attention over the int8 cache with the
current token's self term, o_proj, post-norm, gate-up, SiLU, down_proj, with
the residual rounded to bf16 after each add.  The cache is read without the
current token; the caller writes the returned K/V rows at ``length``.

The kernel is persistent and cooperative (``cudaLaunchCooperativeKernel``,
grid from the occupancy query, so every block is resident); a refused launch
raises.  Its blocks walk fixed queues of work units (:func:`block_queue`) and
wait on ready counters for the tiles each unit reads (:func:`unit_waits`), not
on grid barriers; each block streams its queue's weight tiles and cache chunks
ahead through a shared-memory ring.  :class:`MegaPlan` is the layout of the
launch's scratch regions and sync words, which the kernel checks against its
own; :func:`unit_accesses` names what each unit reads and writes, so
tests/test_torch_decode_mega_plan.py can simulate the plan on the CPU (no
deadlock, each tile produced once a layer, no region overwritten while a
reader is pending).

Gate (``supported``): the JAX gate's shape and format rules (q8_0 fused
weights, every K and N a multiple of 1024, hidden 1024, B <= 8, T a multiple
of 128) plus the kernel's own limits instead of the TPU VMEM budget: head dim
128 and at most 4 query heads per kv head (one attention unit's registers and
shared memory), and the launch's device scratch under MAX_SCRATCH bytes.  The
TPU kernel kept the f32 scores of every position in VMEM, which capped T; here
the scores and each 128-position chunk's softmax and P.V shares go to device
memory (L2-resident at serving sizes), so T is bounded by that scratch alone.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
import struct
from typing import Any, Dict, Optional, Tuple

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
NEG = -1e30
MEGA = _build.Counted("decode_mega", "acestep_tpu_torch/csrc/decode_mega.cu",
                      "acestep_tpu/ops/pallas/decode_mega.py:131")

# one block's stages of a layer, in queue order (stage_times' keys)
STAGES = ("rms+qkv", "heads+scores", "softmax+pv", "o_proj", "norm+gate_up", "act+down")
# f32 scratch regions and 32-bit sync-word groups, in csrc/decode_mega.cu's order
REGIONS = ("part_qkv", "vf", "sself", "eself", "scores", "cmax", "lpart", "apart",
           "part_o", "part_gu", "part_dn")
GROUPS = ("c_qkv", "c_s2", "c_s3", "t_o", "r_o", "c_gu", "t_dn", "r_dn", "done")


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """The launch's work units, scratch regions and sync words at batch
    ``b``, hidden ``h``, ``hq`` / ``hkv`` heads, intermediate ``inter`` and
    cache length ``t_max``."""

    b: int
    h: int
    hq: int
    hkv: int
    inter: int
    t_max: int

    @property
    def nch(self):                 # 128-position chunks of the cache
        return self.t_max // TC

    @property
    def group(self):               # query heads per kv head
        return self.hq // self.hkv

    @property
    def nqkv(self):
        return (self.hq + 2 * self.hkv) * HEAD_DIM

    @property
    def n_qkv(self):               # column tiles of qkv (one head each)
        return self.nqkv // TILE

    @property
    def n_h(self):                 # column tiles of o_proj / down_proj
        return self.h // TILE

    @property
    def n_gu(self):                # column tiles of gate-up
        return 2 * self.inter // TILE

    @property
    def nk1(self):                 # K chunks of qkv and gate-up
        return self.h // TILE

    @property
    def nk4(self):                 # K chunks of o_proj (one query head each)
        return self.hq * HEAD_DIM // TILE

    @property
    def nk6(self):                 # K chunks of down_proj
        return self.inter // TILE

    @property
    def units(self) -> Tuple[int, ...]:
        """Units of each stage: qkv, scores and P.V (b, kv head, chunk),
        o_proj, gate-up, down_proj tiles (column tile fastest)."""
        attn = self.b * self.hkv * self.nch
        return (self.n_qkv * self.nk1, attn, attn, self.n_h * self.nk4, self.n_gu * self.nk1,
                self.n_h * self.nk6)

    @property
    def regions(self) -> Tuple[int, ...]:
        """Offsets (floats) of the scratch regions, each rounded up to 4
        floats, and last the total."""
        b, hq, d, nch = self.b, self.hq, HEAD_DIM, self.nch
        sizes = (self.nk1 * b * self.nqkv, b * self.hkv * d, b * hq, b * hq, b * hq * self.t_max,
                 b * hq * nch, b * hq * nch, b * hq * nch * d, self.nk4 * b * self.h,
                 self.nk1 * b * 2 * self.inter, self.nk6 * b * self.h)
        out = [0]
        for n in sizes:
            out.append(out[-1] + -(-n // 4) * 4)
        return tuple(out)

    @property
    def groups(self) -> Tuple[int, ...]:
        """Offsets (words) of the sync-word groups (arrival counters c_*,
        split-K tickets t_*, publication counters r_*, the leaving count),
        and last the total."""
        bh = self.b * self.hkv
        words = (self.n_qkv, bh, bh, self.n_h, self.n_h, self.n_gu, self.n_h, self.n_h, 1)
        out = [0]
        for n in words:
            out.append(out[-1] + n)
        return tuple(out)


@functools.lru_cache(maxsize=64)
def mega_plan(b: int, h: int, hq: int, hkv: int, inter: int, t_max: int) -> MegaPlan:
    return MegaPlan(b, h, hq, hkv, inter, t_max)


def _chunks(length: int) -> int:
    """Valid 128-position chunks of a row (chunk 0 always: the self term)."""
    return max(1, -(-int(length) // TC))


def _attn_unit(plan: MegaPlan, u: int):
    """(b, kv head, chunk) of attention unit u."""
    return u // (plan.nch * plan.hkv), (u // plan.nch) % plan.hkv, u % plan.nch


def unit_valid(plan: MegaPlan, stage: int, u: int, lengths) -> bool:
    """Attention units past a row's length do nothing (chunk 0 always runs)."""
    if stage not in (1, 2):
        return True
    b, _, c = _attn_unit(plan, u)
    return c == 0 or c * TC < lengths[b]


def block_queue(plan: MegaPlan, block: int, grid: int, lengths, n_layers: int):
    """The units block ``block`` of a ``grid``-block launch runs, in order:
    (layer, stage, unit) with units block, block + grid, ... of each stage."""
    return [(li, s, u) for li in range(n_layers) for s, n in enumerate(plan.units)
            for u in range(block, n, grid) if unit_valid(plan, s, u, lengths)]


def unit_waits(plan: MegaPlan, li: int, stage: int, u: int, lengths):
    """The counters (group, index, least value) unit u of ``stage`` in layer
    ``li`` waits for before it reads its activations (the kernel's spin_ge):
    arrival counts grow by one a producing unit, publication counts by one a
    layer, from 0 at the launch's start."""
    nk1 = plan.nk1
    if stage == 0:                  # the whole residual row after layer li - 1
        return [("r_dn", t, li) for t in range(plan.n_h)] if li else []
    if stage in (1, 2):
        b, h, c = _attn_unit(plan, u)
        if stage == 2:              # every chunk of (b, h) scored
            return [("c_s2", b * plan.hkv + h, (li + 1) * _chunks(lengths[b]))]
        tiles = [h * plan.group + g for g in range(plan.group)]
        if c == 0:
            tiles += [plan.hq + h, plan.hq + plan.hkv + h]
        return [("c_qkv", t, (li + 1) * nk1) for t in tiles]
    if stage == 3:                  # query head kc's attention, every row
        kc = u // plan.n_h
        return [("c_s3", b * plan.hkv + kc // plan.group, (li + 1) * _chunks(lengths[b]))
                for b in range(plan.b)]
    if stage == 4:                  # the whole residual row after o_proj
        return [("r_o", t, li + 1) for t in range(plan.n_h)]
    kc = u // plan.n_h              # down_proj: gate tile kc and up tile
    return [("c_gu", kc, (li + 1) * nk1), ("c_gu", plan.nk6 + kc, (li + 1) * nk1)]


def unit_signal(plan: MegaPlan, stage: int, u: int):
    """The counter (group, index) unit u raises when it is done: an arrival,
    or for o_proj / down_proj the tile's split-K ticket, whose last arrival
    sums the partials into x and raises the tile's publication count
    (``reducer_accesses``)."""
    if stage == 0:
        return "c_qkv", u % plan.n_qkv
    if stage in (1, 2):
        b, h, _ = _attn_unit(plan, u)
        return ("c_s2" if stage == 1 else "c_s3"), b * plan.hkv + h
    if stage == 4:
        return "c_gu", u % plan.n_gu
    return ("t_o" if stage == 3 else "t_dn"), u % plan.n_h


def unit_accesses(plan: MegaPlan, li: int, stage: int, u: int, lengths):
    """(reads, writes) of unit u's activations and scratch, as region keys;
    the residual x as ("x", column tile) (layer 0 reads x0 instead)."""
    hkv, g = plan.hkv, plan.group
    if stage in (1, 2):
        b, h, c = _attn_unit(plan, u)
        if stage == 1:
            tiles = [h * g + q for q in range(g)] + ([plan.hq + h, plan.hq + hkv + h] if c == 0
                                                     else [])
            reads = [("part_qkv", k, t) for k in range(plan.nk1) for t in tiles]
            writes = [("scores", b, h, c), ("cmax", b, h, c)]
            writes += [("vf", b, h), ("sself", b, h)] if c == 0 else []
            return reads, writes
        reads = [("cmax", b, h, j) for j in range(_chunks(lengths[b]))]
        reads += [("sself", b, h), ("scores", b, h, c)]
        writes = [("lpart", b, h, c), ("apart", b, h, c)] + ([("eself", b, h)] if c == 0 else [])
        return reads, writes
    if stage == 0:
        ct, kc = u % plan.n_qkv, u // plan.n_qkv
        reads = [("x", t) for t in range(plan.n_h)] if li else []
        return reads, [("part_qkv", kc, ct)]
    if stage == 3:
        ct, kc = u % plan.n_h, u // plan.n_h
        h = kc // g
        reads = [(r, b, h, j) for b in range(plan.b) for j in range(_chunks(lengths[b]))
                 for r in ("apart", "lpart")]
        reads += [(r, b, h) for b in range(plan.b) for r in ("eself", "vf")]
        return reads, [("part_o", kc, ct)]
    if stage == 4:
        ct, kc = u % plan.n_gu, u // plan.n_gu
        return [("x", t) for t in range(plan.n_h)], [("part_gu", kc, ct)]
    ct, kc = u % plan.n_h, u // plan.n_h
    reads = [("part_gu", k, t) for k in range(plan.nk1) for t in (kc, plan.nk6 + kc)]
    return reads, [("part_dn", kc, ct)]


def reducer_accesses(plan: MegaPlan, li: int, stage: int, ct: int):
    """(reads, writes) of the last block of an o_proj (stage 3) or down_proj
    (stage 5) column tile: the partials in K order and the residual."""
    part, nk = ("part_o", plan.nk4) if stage == 3 else ("part_dn", plan.nk6)
    reads = [(part, k, ct) for k in range(nk)] + ([("x", ct)] if li or stage == 5 else [])
    return reads, [("x", ct)]


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
    plan = mega_plan(b, cfg.hidden_size, cfg.num_attention_heads, nkv, cfg.intermediate_size,
                     t_max)
    return 4 * (plan.regions[-1] + plan.groups[-1]) <= MAX_SCRATCH


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


def scratch_floats(b: int, h: int, hq: int, hkv: int, inter: int, t_max: int) -> int:
    """f32 scratch of one launch (the plan's regions)."""
    return mega_plan(b, h, hq, hkv, inter, t_max).regions[-1]


def stage_times(stamps: torch.Tensor, n_layers: int) -> Dict[str, float]:
    """ms per launch by stage (summed over the layers) from the ``stamps``
    (int64 [2 + 6 L]) of one launch: block 0's clock at the launch's start,
    after its ring's first copies ("setup") and when it finished each of its
    stages, waits included."""
    t = stamps.cpu().double() / 1e6
    n = len(STAGES)
    out = {"setup": float(t[1] - t[0])}
    for s_i, name in enumerate(STAGES):
        out[name] = sum(float(t[2 + n * li + s_i] - t[1 + n * li + s_i])
                        for li in range(n_layers))
    return out


def _check(t, dtype, dev, name, shape=None):
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"decode_mega: {name} must be a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"decode_mega: {name} must be {list(shape)}, got {list(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"decode_mega: {name} must be 16-byte aligned (the kernel copies "
                         "it in 16-byte pieces)")
    return t


NORMS = ("input_norm", "post_norm", "q_norm", "k_norm")
# the weight and norm pointers of the layers objects last checked:
# id(layers) -> (device, the source tensors, their versions, pointers, f16
# scales, the f32 norms the pointers point into)
_layer_memo: Dict[int, tuple] = {}
LAYER_MEMOS = 8
# scratch and sync words per (device, stream, plan): the kernel leaves its sync
# words at 0, so they are zeroed once, when made
_buffers: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
# the C entry's 8-byte slots (csrc/decode_mega.cu enum Slot)
_SLOTS = struct.Struct(f"<{40 + len(REGIONS) + 1 + len(GROUPS) + 1}q")


def _layer_ptrs(layers, n_layers: int, dev):
    """(the 4 weights' data and 4 scale pointers, f16 scales, the 4 norm
    pointers), checked once per layers object and kept while its tensors are
    the same objects, unmodified."""
    ws = _weights(layers)
    tensors = tuple(t for qt in ws for t in (qt.data, qt.scales)) + tuple(layers[nm]
                                                                          for nm in NORMS)
    versions = tuple(t._version for t in tensors)
    memo = _layer_memo.get(id(layers))
    if (memo is not None and memo[0] == dev and memo[2] == versions
            and all(map(operator.is_, memo[1], tensors))):
        return memo[3]
    f16 = ws[0].scales.dtype == torch.float16
    sdt = torch.float16 if f16 else torch.float32
    ptrs = []
    for name, qt in zip(("qkv_proj", "o_proj", "gateup_proj", "down_proj"), ws):
        k, n = qt.shape
        _check(qt.data, torch.int8, dev, f"{name} data", (n_layers, k, n))
        ptrs.append(qt.data.data_ptr())
    for name, qt in zip(("qkv_proj", "o_proj", "gateup_proj", "down_proj"), ws):
        k, n = qt.shape
        _check(qt.scales, sdt, dev, f"{name} scales", (n_layers, k // BLOCK, n))
        ptrs.append(qt.scales.data_ptr())
    norms = [_check(layers[nm].float().contiguous(), torch.float32, dev, nm) for nm in NORMS]
    out = (ptrs, int(f16), [t.data_ptr() for t in norms])
    _layer_memo[id(layers)] = (dev, tensors, versions, out, norms)
    while len(_layer_memo) > LAYER_MEMOS:
        del _layer_memo[next(iter(_layer_memo))]
    return out


def _buffers_for(dev, stream: int, plan: MegaPlan):
    key = (dev, stream, plan)
    buf = _buffers.get(key)
    if buf is None:
        buf = (torch.empty(plan.regions[-1], dtype=torch.float32, device=dev),
               torch.zeros(plan.groups[-1], dtype=torch.int32, device=dev))
        _buffers[key] = buf
    return buf


def decode_layers_mega(layers, cfg, cache_k, cache_ks, cache_v, cache_vs, lengths,
                       x0, cos, sin, grid: int = 0, stamps: Optional[torch.Tensor] = None):
    """Every layer of one decode step -> (x [B, H] f32, k_new [L, B, Hkv, D]
    int8, ks_new [L, B, Hkv] f32, v_new, vs_new).  The caller checks
    :func:`supported` first; ``grid`` overrides the cooperative grid (0: from
    the occupancy query); ``stamps`` (int64 [2 + 6 L] on the card) receives
    block 0's clock in ns at the launch's start, after its first copies and
    when it finished each of the 6 stages of every layer (:func:`stage_times`
    reads them)."""
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
    hq, inter = cfg.num_attention_heads, cfg.intermediate_size
    wptrs, f16, nptrs = _layer_ptrs(layers, n_layers, dev)
    cache_shape = (n_layers, b, hkv, t_max)
    _check(cache_k, torch.int8, dev, "cache_k", (*cache_shape, d))
    _check(cache_v, torch.int8, dev, "cache_v", (*cache_shape, d))
    _check(cache_ks, torch.float32, dev, "cache_ks", cache_shape)
    _check(cache_vs, torch.float32, dev, "cache_vs", cache_shape)
    _check(lengths, torch.int32, dev, "lengths", (b,))
    if x0.dtype not in (torch.bfloat16, torch.float32) or not x0.is_contiguous():
        x0 = x0.float().contiguous()
    if cos.dtype != torch.float32 or not cos.is_contiguous():
        cos = cos.float().contiguous()
    if sin.dtype != torch.float32 or not sin.is_contiguous():
        sin = sin.float().contiguous()
    if stamps is not None:
        _check(stamps, torch.int64, dev, "stamps", (2 + len(STAGES) * n_layers,))
    plan = mega_plan(b, h, hq, hkv, inter, t_max)
    stream = _build.stream_ptr(x0)
    scratch, sync = _buffers_for(dev, stream, plan)
    x = torch.empty((b, h), dtype=torch.float32, device=dev)
    k_new = torch.empty((n_layers, b, hkv, d), dtype=torch.int8, device=dev)
    v_new = torch.empty_like(k_new)
    ks_new = torch.empty((n_layers, b, hkv), dtype=torch.float32, device=dev)
    vs_new = torch.empty_like(ks_new)
    eps_bits = struct.unpack("<i", struct.pack("<f", cfg.rms_norm_eps))[0]
    err = _build.lib().acestep_decode_mega(_SLOTS.pack(
        *wptrs, f16, *nptrs, cache_k.data_ptr(), cache_ks.data_ptr(), cache_v.data_ptr(),
        cache_vs.data_ptr(), lengths.data_ptr(), x0.data_ptr(), x0.dtype is torch.bfloat16,
        cos.data_ptr(), sin.data_ptr(), x.data_ptr(), k_new.data_ptr(), ks_new.data_ptr(),
        v_new.data_ptr(), vs_new.data_ptr(), scratch.data_ptr(), sync.data_ptr(),
        0 if stamps is None else stamps.data_ptr(), n_layers, b, h, hq, hkv, inter, t_max,
        eps_bits, int(grid), stream, *plan.regions, *plan.groups))
    _build.check("acestep_decode_mega", err)
    MEGA.count((b, t_max))
    return x, k_new, ks_new, v_new, vs_new
