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

The function is the Pallas kernels': the cache is read in blocks of ``tb``
positions (the largest of 1024, 512, 256, 128 that divides T) and every
probability is rounded to bf16 against the running max after its block.  The
kernel splits the cache into chunks of 128 positions, one unit of work
each, in two phases (scores and chunk maxima; then P.V against each block's
running max, and a combine in block order): one launch of a thread-block
cluster per (sequence, kv head) where the grid is small, two launches
otherwise.  ``split_attention_mirror`` is that decomposition in plain PyTorch,
for the tests only.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  Shapes the kernels do not take (head dim other
than 128, T not a multiple of 128, more than 8 query heads per kv head) return
None, and the caller keeps the plain layer scan, as the JAX entry points do.
The wrapper's host cost sets its eager time, so it checks the cache tensors
once per set of tensors, passes the kernel one array of slots, and makes the
outputs of a cache's later calls 64 at a time.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import weakref
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


@functools.lru_cache(maxsize=64)
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


def split_attention_mirror(qb, kc_l, ksc_l, vc_l, vsc_l, lengths, k_self, v_self, tb,
                           chunk: int, anchor: str = "block"):
    """Test-only plain mirror of the kernels' phases (nothing on the path calls
    it): the scores as :func:`_online_attention` computes them, sliced into
    chunks of ``chunk`` positions; each chunk's max; the anchor of each ``tb``
    block (the self term and every chunk max of blocks 0..j); each chunk's
    l = sum p and o = sum bf16(p * v_scale) v; the combine in block order,
    chunks summed in order.  ``anchor="global"`` rounds every p against the
    max over all chunks instead (what the kernels must not do)."""
    b, hkv, g, d = qb.shape
    t_max = kc_l.shape[2]
    nch, cpb = t_max // chunk, tb // chunk
    sm_scale = 1.0 / math.sqrt(d)
    s_self = (qb * k_self[:, :, None, :]).sum(-1) * sm_scale               # [B, Hkv, G]
    lengths = lengths.to(device=qb.device, dtype=torch.int64)
    s = []
    for t0 in range(0, t_max, tb):
        k = kc_l[:, :, t0:t0 + tb].float()
        st = torch.einsum("bhgd,bhtd->bhgt", qb, k) * sm_scale
        st = st * ksc_l[:, :, None, t0:t0 + tb]
        pos = t0 + torch.arange(tb, device=qb.device)
        s.append(torch.where(pos[None, None, None, :] < lengths[:, None, None, None], st,
                             torch.full_like(st, NEG_INF)))
    s = torch.cat(s, -1).reshape(b, hkv, g, nch, chunk)
    # chunks past a row's last valid one never run: their max does not count,
    # and their p = exp(-1e30 - m) = 0 with alpha = 1 changes nothing
    nvalid = torch.clamp((lengths + chunk - 1) // chunk, 1, nch)
    ran = torch.arange(nch, device=qb.device)[None, :] < nvalid[:, None]   # [B, NCH]
    cmax = torch.where(ran[:, None, None, :], s.amax(-1), torch.full_like(s[..., 0], NEG_INF))
    if anchor == "global":
        anch = torch.maximum(cmax.amax(-1), s_self)[..., None].expand_as(cmax)
    elif anchor == "block":
        last = (torch.arange(nch, device=qb.device) // cpb + 1) * cpb - 1
        anch = torch.maximum(torch.cummax(cmax, -1).values[..., last], s_self[..., None])
    else:
        raise ValueError(f"anchor={anchor!r}: expected 'block' or 'global'")
    p = torch.exp(s - anch[..., None])
    l_c = p.sum(-1)                                                        # [B, Hkv, G, NCH]
    pv = (p * vsc_l.reshape(b, hkv, 1, nch, chunk)).to(torch.bfloat16).float()
    o_c = torch.einsum("bhgcs,bhcsd->bhgcd", pv, vc_l.reshape(b, hkv, nch, chunk, d).float())
    acc = v_self[:, :, None, :].expand(b, hkv, g, d).clone()
    if anchor == "global":
        e_self = torch.exp(s_self - anch[..., 0])
        return ((acc * e_self[..., None] + o_c.sum(-2)) / (e_self + l_c.sum(-1))[..., None]
                ).reshape(b, hkv * g, d)
    m, l = s_self, torch.ones_like(s_self)
    for j in range(nch // cpb):
        osum, lsum = o_c[..., j * cpb, :], l_c[..., j * cpb]
        for c in range(j * cpb + 1, (j + 1) * cpb):
            osum, lsum = osum + o_c[..., c, :], lsum + l_c[..., c]
        m_j = anch[..., j * cpb]
        alpha = torch.exp(m - m_j)
        acc = acc * alpha[..., None] + osum
        l = l * alpha + lsum
        m = m_j
    return (acc / l[..., None]).reshape(b, hkv * g, d)


def decode_attention_split_mirror(q, kc, ksc, vc, vsc, lengths, li: int, k_self, v_self,
                                  chunk: int = 128, anchor: str = "block"):
    """Row 9's function through :func:`split_attention_mirror` (test-only;
    the kernels' chunk is 128 positions)."""
    b, hq, d = q.shape
    hkv = kc.shape[2]
    qb = q.to(torch.bfloat16).float().reshape(b, hkv, hq // hkv, d)
    return split_attention_mirror(qb, kc[li], ksc[li], vc[li], vsc[li], lengths,
                                  k_self.to(torch.bfloat16).float(),
                                  v_self.to(torch.bfloat16).float(), pick_tb(kc.shape[3]),
                                  chunk, anchor)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

POOL = 64                # outputs made at once for a plan's later calls
CACHES = 4               # caches whose checks and plans are kept (most recent first)
PLANS = 4                # plans kept per cache: one per (stream, query heads)

# the C entry points' slots (csrc/decode_attn.cu, enum Slot): the first 10 per
# plan, then row 9's and row 10's per-call values
_PLAN_SLOTS = struct.Struct("<10q")
_CALL9 = struct.Struct("<7q")
_CALL10 = struct.Struct("<15qd")
_PER_CALL = _PLAN_SLOTS.size

# the caches last checked, most recent first: [device, B, weakrefs of kc, ksc,
# vc, vsc, weakref of the lengths, {(stream, Hq): plan}]
_memos = []


class _Plan:
    """One cache, shapes and stream: the calls' constant slots, the scratch
    they point at, and the next calls' outputs.  A plan's first call makes
    one output; later ones make POOL at a time as views of one allocation per
    output (``torch.empty`` costs more host time than the kernel takes on the
    card); no two calls share one."""

    __slots__ = ("fn9", "fn10", "stream", "buf", "addr", "scratch", "shape", "dev", "outs9",
                 "outs10", "n9", "n10")

    def __init__(self, dev, stream, kc, ksc, vc, vsc, b, hq, hkv, t_max):
        lib = _build.lib()
        self.fn9, self.fn10 = lib.acestep_decode_attn, lib.acestep_decode_attn_fused
        self.stream = stream
        n = lib.acestep_decode_attn_scratch(b, hq, hkv, t_max)
        if n < 0:
            raise ValueError(f"decode attention: the kernels do not take T = {t_max}")
        self.scratch = torch.empty(n, dtype=torch.float32, device=dev)
        self.dev, self.shape = dev, (b, hq, hkv, t_max)
        self.buf = ctypes.create_string_buffer(_PER_CALL + _CALL10.size)
        self.addr = ctypes.addressof(self.buf)
        _PLAN_SLOTS.pack_into(self.buf, 0, kc.data_ptr(), ksc.data_ptr(), vc.data_ptr(),
                              vsc.data_ptr(), self.scratch.data_ptr(), b, hq, hkv, t_max,
                              pick_tb(t_max))
        self.outs9, self.outs10, self.n9, self.n10 = [], [], 1, 1

    def _views(self, n, *shape, dtype=torch.float32):
        """n tensors of ``shape``, views of one allocation, and their pointers."""
        a = torch.empty((n, *shape), dtype=dtype, device=self.dev)
        step = a[0].nbytes
        return a.unbind(0), range(a.data_ptr(), a.data_ptr() + n * step, step)

    def out9(self):
        """(out [B, Hq, D] f32, its pointer) for a row 9 call."""
        if not self.outs9:
            b, hq = self.shape[:2]
            self.outs9 = list(zip(*self._views(self.n9, b, hq, HEAD_DIM)))
            self.n9 = POOL
        return self.outs9.pop()

    def out10(self):
        """((out, k_new, k_scale, v_new, v_scale), their pointers) for a row 10 call."""
        if not self.outs10:
            b, hq, hkv = self.shape[:3]
            n = self.n10
            outs, ptrs = zip(*(self._views(n, b, hq, HEAD_DIM),
                               self._views(n, b, hkv, HEAD_DIM, dtype=torch.int8),
                               self._views(n, b, hkv),
                               self._views(n, b, hkv, HEAD_DIM, dtype=torch.int8),
                               self._views(n, b, hkv)))
            self.outs10 = list(zip(zip(*outs), zip(*ptrs)))
            self.n10 = POOL
        return self.outs10.pop()


def _check_cache(kc, ksc, vc, vsc, dev, b):
    n_l, bc, hkv, t_max, d = kc.shape
    for name, a, dtype, shape in (("kc", kc, torch.int8, kc.shape),
                                  ("vc", vc, torch.int8, kc.shape),
                                  ("ksc", ksc, torch.float32, kc.shape[:4]),
                                  ("vsc", vsc, torch.float32, kc.shape[:4])):
        if a.dtype != dtype or tuple(a.shape) != tuple(shape) or not a.is_contiguous() \
                or a.device != dev:
            raise ValueError(f"decode attention: {name} must be a contiguous {dtype} "
                             f"{tuple(shape)} on {dev}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")
        if a.data_ptr() % 16:
            raise ValueError(f"decode attention: {name} must start on a 16-byte boundary")
    if bc != b:
        raise ValueError(f"decode attention: cache batch {bc} != query batch {b}")


def _plan(dev, kc, ksc, vc, vsc, lengths, li, n_l, b, hq, hkv, t_max):
    """Every check rows 9 and 10 share, then the call's plan (per stream).  The
    cache tensors are checked once per set of tensors (and device and batch),
    the lengths once per tensor: one replaced by another is checked anew."""
    if dev.type != "cuda":
        raise ValueError(f"decode attention: unsupported device {dev}")
    for i, memo in enumerate(_memos):
        if memo[2]() is kc and memo[3]() is ksc and memo[4]() is vc and memo[5]() is vsc \
                and memo[1] == b and memo[0] == dev:
            if i:
                _memos.insert(0, _memos.pop(i))
            break
    else:
        _check_cache(kc, ksc, vc, vsc, dev, b)
        memo = [dev, b, *(weakref.ref(a) for a in (kc, ksc, vc, vsc)), None, {}]
        _memos.insert(0, memo)
        del _memos[CACHES:]
    if memo[6] is None or memo[6]() is not lengths:
        if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) \
                or not lengths.is_contiguous() or lengths.device != dev:
            raise ValueError(f"decode attention: lengths must be a contiguous torch.int32 "
                             f"({b},) on {dev}, got {lengths.dtype} {tuple(lengths.shape)} "
                             f"on {lengths.device}")
        memo[6] = weakref.ref(lengths)
    if not 0 <= li < n_l:
        raise ValueError(f"decode attention: layer {li} of {n_l}")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    plans = memo[7]
    plan = plans.get((stream, hq))
    if plan is None:
        if len(plans) >= PLANS:
            del plans[next(iter(plans))]
        plan = plans[(stream, hq)] = _Plan(dev, stream, kc, ksc, vc, vsc, b, hq, hkv, t_max)
    return plan


def _bf16(x):
    return x if x.dtype is torch.bfloat16 and x.is_contiguous() \
        else x.to(torch.bfloat16).contiguous()


def _f32(x):
    return x if x.dtype is torch.float32 and x.is_contiguous() \
        else x.to(torch.float32).contiguous()


def decode_attention_int8_stacked(q, kc, ksc, vc, vsc, lengths, li: int, k_self, v_self):
    """Single-token GQA attention for layer ``li`` -> [B, Hq, D] f32, or None
    for shapes the kernel does not take."""
    b, hq, d = q.shape
    n_l, _, hkv, t_max, _ = kc.shape
    if not takes(hq, hkv, d, t_max):
        return None
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, kc, ksc, vc, vsc, lengths, li, k_self, v_self)
    plan = _plan(dev, kc, ksc, vc, vsc, lengths, li, n_l, b, hq, hkv, t_max)
    q, k_self, v_self = _bf16(q), _bf16(k_self), _bf16(v_self)
    out, out_ptr = plan.out9()
    _CALL9.pack_into(plan.buf, _PER_CALL, lengths.data_ptr(), li, plan.stream, q.data_ptr(),
                     k_self.data_ptr(), v_self.data_ptr(), out_ptr)
    _build.check("acestep_decode_attn", plan.fn9(plan.addr))
    ATTN.count(plan.shape)
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
    dev = q_raw.device
    if dev.type == "cpu":
        return decode_attention_fused_plain(q_raw, k_raw, v_raw, q_norm, k_norm, cos, sin,
                                            kc, ksc, vc, vsc, lengths, li, eps)
    plan = _plan(dev, kc, ksc, vc, vsc, lengths, li, n_l, b, hq, hkv, t_max)
    q_raw, k_raw, v_raw = _bf16(q_raw), _bf16(k_raw), _bf16(v_raw)
    q_norm, k_norm, cos, sin = _f32(q_norm), _f32(k_norm), _f32(cos), _f32(sin)
    outs, (out, k_new, ks_new, v_new, vs_new) = plan.out10()
    _CALL10.pack_into(plan.buf, _PER_CALL, lengths.data_ptr(), li, plan.stream, q_raw.data_ptr(),
                      k_raw.data_ptr(), v_raw.data_ptr(), out, q_norm.data_ptr(),
                      k_norm.data_ptr(), cos.data_ptr(), sin.data_ptr(), k_new, ks_new, v_new,
                      vs_new, eps)
    _build.check("acestep_decode_attn_fused", plan.fn10(plan.addr))
    FUSED.count(plan.shape)
    return outs
