"""Every DiT decoder layer of one Euler step in one launch: CUDA megakernel
wrapper, its plan, its plain PyTorch version and the shape/format gate
(opt-in: the JAX package's ``ACESTEP_TPU_DIT_MEGA=1``, here
``dit.forward(..., dit_mega=True)``).

Kernel: ``csrc/dit_mega.cu`` (hand-written for sm_90a) replaces
``acestep_tpu/ops/pallas/dit_mega.py:158 _mega_kernel`` (via
``dit_layers_mega``, :381).  Per layer: AdaLN (RMSNorm and the 6-row
modulation), the fused qkv GEMM, q/k RMSNorm and NEOX rope, GQA self-attention
with the per-layer sliding band, o_proj and the gated residual, the cross
norm, cross q and attention over the cached condition K/V with the additive
encoder mask, cross o_proj and its residual, the modulated MLP input, gate-up,
SiLU(gate) * up, down and the gated residual.  The residual stream stays f32
through all layers.

The kernel is persistent (every block resident: the grid is the number of
3-block clusters the card holds at once, checked by the C entry) and has no
grid barrier.  Its blocks walk fixed queues of work units (:func:`block_queue`)
and wait on ready counters for what each unit reads (:func:`unit_waits`).  A
GEMM job is one output tile over all K, computed by the three blocks of one
cluster (each a third of K) and summed in rank order through distributed
shared memory, so no split-K partial goes through device memory; the job's
epilogue does the stage's light work (q/k norm and rope, SiLU(g) * u, the
residual add).  The three row norms are units of their own
(``NT`` tokens each).  :class:`DitPlan` is the layout of the launch's scratch
regions and sync words, which the kernel checks against its own;
:func:`unit_accesses` names what each unit reads and writes, so
tests/test_torch_dit_mega_plan.py simulates the plan on the CPU (no deadlock,
each tile produced once a layer, no region overwritten while a reader is
pending, the split-K order fixed).

Gate (``supported``): the JAX gate's shape and format rules (batch 1; q8_0
fused, stacked weights with f32 scales; every K and N a multiple of the chunk
edge ``min(H, 1024)``; T a multiple of 8) with head dim 128 and H a multiple of
128 (the kernel's tiles: one qkv column tile is one head).  In place of the
TPU's 12 MiB VMEM budget the attention rows are capped at ``LK_MAX`` (the
longest row the first CUDA design held in shared memory; this design streams
K and V in chunks and keeps admitting every length it did) and the layers at
``MAX_LAYERS``.  So the port admits every case the JAX gate admits and more,
for example the full-width DiT at T = 256 patch tokens (20.48 s), which the
JAX VMEM estimate declines (16.5-17.1 MiB > 12 MiB).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.nn import rotate_half
from acestep_tpu_torch.quant import QuantTensor, dequantize

NEG = -1e30
CH_MAX = 1024            # the JAX gate's chunk edge: min(H, 1024)
HEAD_DIM = 128
LK_MAX = 54880           # longest attention row (max(T, Lc)) the gate admits
MAX_LAYERS = 512         # sliding flags travel as 8 words of bits
THREADS = 256
CS = 3                   # blocks of a cluster: the K splits of a GEMM job
TT = 128                 # tokens of a GEMM pass (the wgmma width)
KSTEP = 128              # K rows of a weight tile
NT = 8                   # tokens of a norm unit
QB = 16                  # query rows of an attention unit
KC = 64                  # keys of an attention chunk
WR, XR = 3, 4            # slots of the weight ring and of the activation ring
MEGA = _build.Counted("dit_mega", "acestep_tpu_torch/csrc/dit_mega.cu",
                      "acestep_tpu/ops/pallas/dit_mega.py:158")

# shared memory of one block (bytes; csrc/dit_mega.cu mirrors each constant):
# the activation ring (also the parked partial tile and the attention
# chunks), the weight ring, then mbarriers and small scratch
X_SLOT = 2 * TT * 128                          # a K step of x: two 64-wide atoms
W_SLOT = 2 * KSTEP * 64 + 2 * 4 * 64 * 4       # two 64-column int8 halves, their scales
PARK = TT * (128 + 4) * 4                      # a partial tile [TT][128 + 4] f32
ATTN = 6 * KC * (2 * HEAD_DIM + 16)            # 6 chunks of KC padded K or V rows
XREG = max(XR * X_SLOT, PARK, ATTN)
MISC = 2048
SMEM = 1024 + XREG + WR * W_SLOT + MISC        # + 1024: the base aligned to 1024

# one block's stages of a layer, in queue order (stage_times' keys)
STAGES = ("norm sa", "qkv", "self-attn", "o_proj", "norm cross", "cross q", "cross-attn",
          "cross o_proj", "norm mlp", "gate-up", "down")
NORM_SA, QKV, SELF, SO, NORM_CA, CQ, CROSS, CO, NORM_MLP, GU, DN = range(len(STAGES))
GEMMS = (QKV, SO, CQ, CO, GU, DN)
MODE_A = (QKV, GU)       # both warpgroups one K step (qkv: a head; gate-up: g and u)
NORM_KIND = {NORM_SA: 0, NORM_CA: 1, NORM_MLP: 2}
PANEL = {QKV: 0, CQ: 1, GU: 2}                 # the norm kind whose output a GEMM reads
RESID = {SO: 0, CO: 1, DN: 2}                  # the residual stages' counters
# phases of a queue item: a GEMM job's accumulation, its reduction and
# epilogue, the cluster's hand-back of the parked tiles; any other unit
ACC, RED, SYNC, UNIT = range(4)
# scratch regions (bytes) and sync-word groups, in csrc/dit_mega.cu's order
REGIONS = ("xa_sa", "xa_ca", "xa_mlp", "qb", "kb", "vb", "attn_s", "attn_c", "qc", "act")
GROUPS = ("norm", "qkv", "self", "cq", "cross", "resid", "gu", "done")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class DitPlan:
    """The launch's work units, scratch regions and sync words at T tokens,
    hidden ``h``, ``hq`` / ``hkv`` heads of dim 128, intermediate ``inter``,
    on a ``grid``-block launch (``grid // CS`` clusters)."""

    t: int
    h: int
    hq: int
    hkv: int
    inter: int
    grid: int

    @property
    def ncl(self) -> int:               # clusters (blocks past the last take no GEMM job)
        return self.grid // CS

    @property
    def passes(self) -> int:            # GEMM passes of TT tokens
        return _cdiv(self.t, TT)

    @property
    def group(self) -> int:             # query heads per kv head
        return self.hq // self.hkv

    @property
    def pairs(self) -> int:             # query-head pairs of a kv head (an attention unit's)
        return _cdiv(self.group, 2)

    @property
    def nqb(self) -> int:               # query blocks of QB rows
        return _cdiv(self.t, QB)

    @property
    def n_norm(self) -> int:
        return _cdiv(self.t, NT)

    @property
    def shares(self) -> int:            # token shares: CS a pass (one rank's epilogue rows)
        return self.passes * CS

    def share(self, sh: int) -> Tuple[int, int]:
        """Tokens [lo, hi) of share sh: rank sh % CS's rows of pass sh // CS
        (hi <= lo: the share is empty)."""
        p, r = divmod(sh, CS)
        return (p * TT + r * TT // CS, min(self.t, p * TT + (r + 1) * TT // CS))

    def shares_of(self, lo: int, hi: int):
        """The non-empty shares holding tokens of [lo, hi)."""
        return [sh for sh in range(self.shares)
                if max(lo, self.share(sh)[0]) < min(hi, self.share(sh)[1])]

    def gemm(self, stage: int) -> Tuple[int, int]:
        """(K, N) of a GEMM stage."""
        qdim = self.hq * HEAD_DIM
        return {QKV: (self.h, qdim + 2 * self.hkv * HEAD_DIM), SO: (qdim, self.h),
                CQ: (self.h, qdim), CO: (qdim, self.h), GU: (self.h, 2 * self.inter),
                DN: (self.inter, self.h)}[stage]

    def units(self, stage: int) -> int:
        """Units of a stage: GEMM jobs (qkv: a head of 128 columns; gate-up:
        64 gate and the matching 64 up columns; the rest 64 columns), norm
        units of NT tokens, attention units (kv head, query-head pair, QB
        query rows)."""
        if stage in GEMMS:
            n = self.gemm(stage)[1]
            if stage == QKV:
                return n // HEAD_DIM
            return _cdiv(self.inter, 64) if stage == GU else _cdiv(n, 64)
        if stage in NORM_KIND:
            return self.n_norm
        return self.hkv * self.pairs * self.nqb

    def k_ranges(self, stage: int) -> Tuple[Tuple[int, int], ...]:
        """Each cluster rank's K steps [begin, end) of a GEMM job: contiguous,
        in rank order (the order the partial tiles are summed in); in the
        64-column stages an even count, the two warpgroups taking alternate
        steps."""
        steps = _cdiv(self.gemm(stage)[0], KSTEP)
        per = _cdiv(steps, CS)
        if stage not in MODE_A:
            per = _cdiv(per, 2) * 2
        return tuple((min(r * per, steps), min((r + 1) * per, steps)) for r in range(CS))

    @property
    def regions(self) -> Tuple[int, ...]:
        """Byte offsets of the scratch regions, each rounded up to 256 bytes,
        and last the total."""
        t, qdim = self.t, self.hq * HEAD_DIM
        sizes = (t * self.h * 2,) * 3 + (qdim * t * 2, self.hkv * HEAD_DIM * t * 2,
                                         self.hkv * HEAD_DIM * t * 2, t * qdim * 2, t * qdim * 2,
                                         t * qdim * 4, t * self.inter * 2)
        out = [0]
        for n in sizes:
            out.append(out[-1] + _cdiv(n, 256) * 256)
        return tuple(out)

    @property
    def groups(self) -> Tuple[int, ...]:
        """Word offsets of the sync-word groups (norm units by kind, qkv
        heads, self-attention by kv head, cross-q tiles, cross-attention by kv
        head, the three residual stages, gate-up, the leaving count), and last
        the total."""
        words = (3, self.units(QKV), self.hkv, self.units(CQ), self.hkv, 3, 1, 1)
        out = [0]
        for n in words:
            out.append(out[-1] + n)
        return tuple(out)

    def per_layer(self, group: str) -> int:
        """How much one layer raises each counter of ``group``."""
        if group == "norm":
            return self.n_norm
        if group in ("self", "cross"):
            return self.pairs * self.nqb
        return CS * self.passes


@functools.lru_cache(maxsize=64)
def dit_plan(t: int, h: int, hq: int, hkv: int, inter: int, grid: int) -> DitPlan:
    return DitPlan(t, h, hq, hkv, inter, grid)


def block_queue(plan: DitPlan, block: int, n_layers: int):
    """The items block ``block`` runs, in order: (layer, stage, unit, pass,
    phase).  A GEMM job j goes to cluster j % ncl, whose blocks each run its
    ACC, RED and SYNC phases for every pass; unit u of any other stage to the
    block at position u % grid of the rank-major order (rank 0 of every
    cluster first), so that consecutive units land in different clusters."""
    c, r = divmod(block, CS)
    clustered = c < plan.ncl
    pos = r * plan.ncl + c if clustered else block
    queue = []
    for li in range(n_layers):
        for s in range(len(STAGES)):
            if s in GEMMS:
                if clustered:
                    for j in range(c, plan.units(s), plan.ncl):
                        for p in range(plan.passes):
                            queue += [(li, s, j, p, ph) for ph in (ACC, RED, SYNC)]
            else:
                queue += [(li, s, u, 0, UNIT) for u in range(pos, plan.units(s), plan.grid)]
    return queue


def _heads(plan: DitPlan, kv: int, pair: int):
    g = plan.group
    return [kv * g + 2 * pair + i for i in range(2) if 2 * pair + i < g]


def _attn_unit(plan: DitPlan, u: int):
    """(kv head, query-head pair, query block) of attention unit u."""
    return u // (plan.pairs * plan.nqb), (u // plan.nqb) % plan.pairs, u % plan.nqb


def unit_waits(plan: DitPlan, li: int, stage: int, u: int, rank: int = 0):
    """The counters (group, index, least value) an ACC phase or a unit
    waits for before it reads (the kernel's wait_item); counters grow from 0
    through the launch."""
    done = lambda group: plan.per_layer(group) * (li + 1)      # noqa: E731
    if stage in NORM_KIND:
        if stage == NORM_SA:
            prev = plan.units(DN) * plan.per_layer("resid") * li
            return [("resid", RESID[DN], prev)] if li else []
        src = SO if stage == NORM_CA else CO
        return [("resid", RESID[src], plan.units(src) * done("resid"))]
    if stage in PANEL:
        return [("norm", PANEL[stage], done("norm"))]
    if stage in (SO, CO):
        sb, se = plan.k_ranges(stage)[rank]
        kvs = sorted({h // plan.group for h in range(sb, se)})
        return [("self" if stage == SO else "cross", g, done("self")) for g in kvs]
    if stage == DN:
        return [("gu", 0, plan.units(GU) * done("gu"))]
    kv, pair, _ = _attn_unit(plan, u)
    heads = _heads(plan, kv, pair)
    if stage == SELF:
        tiles = heads + [plan.hq + kv, plan.hq + plan.hkv + kv]
        return [("qkv", t, done("qkv")) for t in tiles]
    return [("cq", 2 * h + i, done("cq")) for h in heads for i in range(2)]


def unit_signal(plan: DitPlan, stage: int, u: int, phase: int):
    """The counter (group, index) an item raises when it is done (None: no
    counter): a GEMM job's RED phase in every rank and pass, every other
    unit once."""
    if phase in (ACC, SYNC):
        return None
    if stage in GEMMS:
        if stage in RESID:
            return "resid", RESID[stage]
        return ("qkv", u) if stage == QKV else ("cq", u) if stage == CQ else ("gu", 0)
    if stage in NORM_KIND:
        return "norm", NORM_KIND[stage]
    return ("self" if stage == SELF else "cross"), _attn_unit(plan, u)[0]


def _pass_keys(plan: DitPlan, p: int, size: int):
    """Indices of the ``size``-token groups holding tokens of pass p."""
    lo, hi = p * TT, min((p + 1) * TT, plan.t)
    return range(lo // size, _cdiv(hi, size))


def unit_accesses(plan: DitPlan, li: int, stage: int, u: int, p: int, phase: int,
                  rank: int = 0):
    """(reads, writes) of an item's scratch and residual, as region keys:
    ("x", share, 64-column tile) with a share one rank's rows of a pass
    (:meth:`DitPlan.share`; layer 0's first residual reads the input x0
    instead); ("xa", kind, norm unit); ("qkv", head tile, share); ("attn_s" |
    "attn_c", head, query block); ("qc", 64-column tile, share); ("act",
    gate-up job, share)."""
    if phase == SYNC:
        return [], []
    pass_tokens = (p * TT, min((p + 1) * TT, plan.t))
    if phase == ACC:
        sb, se = plan.k_ranges(stage)[rank]
        if stage in PANEL:
            return [("xa", PANEL[stage], g) for g in _pass_keys(plan, p, NT)], []
        if stage in (SO, CO):
            name = "attn_s" if stage == SO else "attn_c"
            return [(name, h, q) for h in range(sb, se) for q in _pass_keys(plan, p, QB)], []
        blocks = range(2 * sb, min(2 * se, plan.units(GU)))         # 64-column act blocks
        return [("act", j, sh) for j in blocks for sh in plan.shares_of(*pass_tokens)], []
    if phase == RED:
        sh = p * CS + rank
        lo, hi = plan.share(sh)
        if hi <= lo:
            return [], []
        if stage in RESID:
            reads = [] if (stage == SO and li == 0) else [("x", sh, u)]
            return reads, [("x", sh, u)]
        name = {QKV: "qkv", CQ: "qc", GU: "act"}[stage]
        return [], [(name, u, sh)]
    if stage in NORM_KIND:
        kind = NORM_KIND[stage]
        reads = [] if (stage == NORM_SA and li == 0) else \
            [("x", sh, tile) for sh in plan.shares_of(u * NT, (u + 1) * NT)
             for tile in range(plan.units(SO))]
        return reads, [("xa", kind, u)]
    kv, pair, qb = _attn_unit(plan, u)
    heads = _heads(plan, kv, pair)
    q_shares = plan.shares_of(qb * QB, (qb + 1) * QB)
    if stage == SELF:
        reads = [("qkv", h, sh) for h in heads for sh in q_shares]
        reads += [("qkv", t, sh) for t in (plan.hq + kv, plan.hq + plan.hkv + kv)
                  for sh in plan.shares_of(0, plan.t)]
        return reads, [("attn_s", h, qb) for h in heads]
    reads = [("qc", 2 * h + i, sh) for h in heads for i in range(2) for sh in q_shares]
    return reads, [("attn_c", h, qb) for h in heads]


def _weights(layers: Dict[str, Any]):
    sa, ca, mlp = layers["self_attn"], layers["cross_attn"], layers["mlp"]
    return (sa["qkv_proj"]["kernel"], sa["o_proj"]["kernel"],
            ca["q_proj"]["kernel"], ca["o_proj"]["kernel"],
            mlp["gateup_proj"]["kernel"], mlp["down_proj"]["kernel"])


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
    if cfg.head_dim != HEAD_DIM or h % 128 or t % 8 or t < 8:
        return False
    if ws[0].num_layers > MAX_LAYERS:
        return False
    return max(t, lc) <= LK_MAX


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

def stage_times(stamps: torch.Tensor, n_layers: int) -> Dict[str, float]:
    """ms per launch by stage (summed over the layers) from the ``stamps``
    (int64 [2 + 11 L]) of one launch: block 0's clock at the launch's start,
    after its rings' first copies ("setup") and when it finished each of its
    stages, waits included."""
    t = stamps.cpu().double() / 1e6
    n = len(STAGES)
    out = {"setup": float(t[1] - t[0])}
    for s_i, name in enumerate(STAGES):
        out[name] = sum(float(t[2 + n * li + s_i] - t[1 + n * li + s_i])
                        for li in range(n_layers))
    return out


def _contig(t, dtype, dev, name, shape=None):
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"dit_mega: {name} must be a contiguous {dtype} tensor on {dev}, "
                         f"got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"dit_mega: {name} {tuple(t.shape)} where {tuple(shape)} is expected")
    if t.data_ptr() % 16:
        raise ValueError(f"dit_mega: {name} must be 16-byte aligned (the kernel copies it "
                         "in 16-byte pieces)")
    return t


# scratch and sync words per (device, stream, plan): the kernel leaves its sync
# words at 0, so they are zeroed once, when made
_buffers: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_grid: Dict[int, int] = {}
# the C entry's 8-byte slots (csrc/dit_mega.cu enum Slot)
_SLOTS = struct.Struct(f"<{51 + len(REGIONS) + 1 + len(GROUPS) + 1}q")


def _buffers_for(dev, stream: int, plan: DitPlan):
    key = (dev, stream, plan)
    buf = _buffers.get(key)
    if buf is None:
        buf = (torch.empty(plan.regions[-1], dtype=torch.uint8, device=dev),
               torch.zeros(plan.groups[-1], dtype=torch.int32, device=dev))
        _buffers[key] = buf
    return buf


def default_grid(dev) -> int:
    """Blocks of the launch: CS x the clusters the card holds at once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _grid:
        grid = _build.lib().acestep_dit_mega_grid()
        if grid <= 0:
            raise RuntimeError(f"dit_mega: occupancy query gave {grid} blocks")
        _grid[idx] = grid
    return _grid[idx]


def _bits(v: float) -> int:
    return struct.unpack("<i", struct.pack("<f", v))[0]


def dit_layers_mega(layers, cfg, x, k_stack, v_stack, timestep_proj, cos, sin,
                    sliding_flags: Sequence, enc_mask_add, grid: int = 0,
                    stamps: Optional[torch.Tensor] = None):
    """Every decoder layer of one Euler step -> x [1, T, H] f32 (arguments as
    :func:`dit_layers_mega_plain`).  The caller checks :func:`supported`
    first; ``grid`` overrides the launch's blocks (0: :func:`default_grid`;
    a grid the card cannot hold at once is refused and raises); ``stamps``
    (int64 [2 + 11 L] on the card) receives block 0's clock in ns at the
    launch's start, after its rings' first copies and when it finished each
    of the 11 stages of every layer (:func:`stage_times` reads them)."""
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
    plan = dit_plan(t, h, hq, hkv, inter, int(grid) if grid > 0 else default_grid(dev))
    ptrs, scales = [], []
    for qt, stage in zip(_weights(layers), GEMMS):
        k, n = plan.gemm(stage)
        _contig(qt.data, torch.int8, dev, "weight data", (n_layers, k, n))
        _contig(qt.scales, torch.float32, dev, "weight scales", (n_layers, k // 32, n))
        ptrs.append(qt.data.data_ptr())
        scales.append(qt.scales.data_ptr())
    sa, ca = layers["self_attn"], layers["cross_attn"]
    small = [layers["self_attn_norm"], layers["cross_attn_norm"], layers["mlp_norm"],
             layers["scale_shift_table"], sa["q_norm"], sa["k_norm"], ca["q_norm"]]
    small_f32 = not all(s.dtype == torch.bfloat16 for s in small)
    small = [(s.float() if small_f32 else s).contiguous() for s in small]
    for s, shape in zip(small, ((n_layers, h),) * 3 + ((n_layers, 6, h),) + ((n_layers, d),) * 3):
        if tuple(s.shape) != shape or s.device != dev:
            raise ValueError(f"dit_mega: layer tensor {tuple(s.shape)} on {s.device} where "
                             f"{shape} on {dev} is expected")
    ks = _contig(ks.to(torch.bfloat16).contiguous(), torch.bfloat16, dev, "cross K")
    vs = _contig(vs.to(torch.bfloat16).contiguous(), torch.bfloat16, dev, "cross V")
    x0 = _contig(x.reshape(t, h).float().contiguous(), torch.float32, dev, "x")
    tproj = tproj.contiguous()
    cos = _contig(cos.float().contiguous(), torch.float32, dev, "cos", (t, d))
    sin = _contig(sin.float().contiguous(), torch.float32, dev, "sin", (t, d))
    encm = enc_mask_add.reshape(lc).float().contiguous()
    if stamps is not None:
        _contig(stamps, torch.int64, dev, "stamps", (2 + len(STAGES) * n_layers,))
    stream = _build.stream_ptr(x)
    scratch, sync = _buffers_for(dev, stream, plan)
    out = torch.empty((t, h), dtype=torch.float32, device=dev)
    words = [0] * 8
    for li, f in enumerate(sliding_flags):
        if f:
            words[li // 64] |= 1 << (li % 64)
    words = [w - (1 << 64) if w >= 1 << 63 else w for w in words]
    err = _build.lib().acestep_dit_mega(_SLOTS.pack(
        *ptrs, *scales, *(a.data_ptr() for a in small), int(small_f32),
        ks.data_ptr(), vs.data_ptr(), x0.data_ptr(), tproj.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), encm.data_ptr(), out.data_ptr(), scratch.data_ptr(), sync.data_ptr(),
        0 if stamps is None else stamps.data_ptr(), n_layers, t, h, hq, hkv, inter, lc,
        cfg.sliding_window, plan.grid, _bits(cfg.rms_norm_eps), _bits(1.0 / math.sqrt(d)),
        stream, *words, *plan.regions, *plan.groups))
    _build.check("acestep_dit_mega", err)
    MEGA.count((t, lc))
    return out[None]
