"""GGML-style block-quant formats in the JAX package's kernel layout.

A weight is stored as ``[K, N]`` (contraction axis first, ``y = x @ W``); the
quant blocks run along K, so every field concatenates exactly along N.
Layer-stacked weights carry a leading layer axis ``[L, ...]`` on every field
while ``shape`` stays the logical ``(K, N)``.

  q8_0  data int8 [K, N], scales f16 [K/32, N]                       8.5 bpw
  q4_0  data uint8 [K/2, N] (fold-256 nibbles, value - 8),
        scales f16 [K/32, N]                                         4.5 bpw
  q4_k  data uint8 [K/2, N] (fold-256 nibbles, 0..15), 6-bit sub-scales
        and sub-mins uint8 [K/32, N], super_scales / super_mins f16
        [K/256, N]: w = q * (super * ls) - (super_min * lm)           ~4.63 bpw
  q6_k  data uint8 [K/2, N] (low nibbles, fold-256), data_hi uint8 [K/4, N]
        (high 2 bits, fold-64 crumbs), sub_scales int8 [K/16, N],
        super_scales f16 [K/256, N]: w = ((lo | hi << 4) - 32) * (super * ls)
                                                                     ~6.56 bpw

The engine pre-casts the f16 ``scales`` / ``super_scales`` / ``super_mins`` to
f32 once (``ops.qlinear.precast_quant_scales``); sub-scales keep their integer
type.  The quantizers are bit-exact with the JAX package's numpy reference
quantizers and run wherever the weight lies, so a random engine is drawn and
quantized on the card one tensor at a time.  Dequant runs in f32 (each
multiply and subtract rounded on its own) and rounds once to the output dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

BLOCK = 32       # elements per quant block (q8_0 / q4_0 / q4_k scale granularity)
SUPER = 256      # elements per super-block (q4_k / q6_k)
SUB16 = 16       # q6_k sub-block (16 sub-blocks of 16 per super-block)
FOLD = 256       # 4-bit fold group: rows g*256+r in the low nibble, g*256+128+r high

QUANT_FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
FOUR_BIT = ("q4_0", "q4_k", "q6_k")
FIELDS = ("data", "data_hi", "scales", "sub_scales", "sub_mins", "super_scales",
          "super_mins")
# the fields each format carries (others are None)
FORMAT_FIELDS = {
    "q8_0": ("data", "scales"),
    "q4_0": ("data", "scales"),
    "q4_k": ("data", "sub_scales", "sub_mins", "super_scales", "super_mins"),
    "q6_k": ("data", "data_hi", "sub_scales", "super_scales"),
}


@dataclasses.dataclass
class QuantTensor:
    """A block-quantized weight in kernel layout ``[K, N]`` (or stacked
    ``[L, K, N]``); field shapes and types as in the module docstring."""

    fmt: str
    shape: Tuple[int, int]                        # logical (K, N)
    data: torch.Tensor
    scales: Optional[torch.Tensor] = None
    data_hi: Optional[torch.Tensor] = None
    sub_scales: Optional[torch.Tensor] = None
    sub_mins: Optional[torch.Tensor] = None
    super_scales: Optional[torch.Tensor] = None
    super_mins: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.fmt not in QUANT_FORMATS:
            raise ValueError(f"unknown quant format {self.fmt!r} "
                             f"(the port has {', '.join(QUANT_FORMATS)})")
        k = self.shape[0]
        if self.fmt in FOUR_BIT and k % FOLD:
            raise ValueError(f"{self.fmt} needs K % {FOLD} == 0, got K={k}")
        if k % BLOCK:
            raise ValueError(f"{self.fmt} needs K % {BLOCK} == 0, got K={k}")
        missing = [f for f in FORMAT_FIELDS[self.fmt] if getattr(self, f) is None]
        if missing:
            raise ValueError(f"{self.fmt} weight lacks {missing}")

    def fields(self) -> Dict[str, torch.Tensor]:
        """The tensors this weight carries, by field name."""
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}

    def map(self, fn) -> "QuantTensor":
        """A weight of the same format with ``fn`` applied to every field."""
        return QuantTensor(self.fmt, self.shape,
                           **{f: fn(a) for f, a in self.fields().items()})

    @property
    def stacked(self) -> bool:
        return self.data.dim() == 3

    @property
    def num_layers(self) -> int:
        return self.data.shape[0] if self.stacked else 1

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.fields().values())

    def layer(self, li: int) -> "QuantTensor":
        """View of layer ``li`` of a stacked weight (no copy)."""
        return self.map(lambda a: a[li])

    def to(self, device) -> "QuantTensor":
        return self.map(lambda a: a.to(device))


def stack_layers(qts: Sequence[QuantTensor]) -> QuantTensor:
    """Per-layer weights of one format -> one weight with a leading layer axis."""
    return QuantTensor(qts[0].fmt, qts[0].shape,
                       **{f: torch.stack([getattr(q, f) for q in qts])
                          for f in qts[0].fields()})


def concat_n(qts: Sequence[QuantTensor]) -> QuantTensor:
    """Concatenate weights of one format along N (exact column-for-column:
    blocks run along K).  Used to fuse q||k||v and gate||up."""
    if len({q.fmt for q in qts}) != 1:
        raise ValueError(f"concat_n: mixed formats {[q.fmt for q in qts]}")
    return QuantTensor(qts[0].fmt, (qts[0].shape[0], sum(q.shape[1] for q in qts)),
                       **{f: torch.cat([getattr(q, f) for q in qts], dim=-1)
                          for f in qts[0].fields()})


# ---------------------------------------------------------------------------
# packing (fold-256 nibbles, fold-64 crumbs); leading axes pass through
# ---------------------------------------------------------------------------

def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """4-bit values ``[..., K, N]`` -> uint8 ``[..., K/2, N]``:
    ``packed[g*128 + r] = q[g*256 + r] | q[g*256 + 128 + r] << 4``."""
    *lead, k, n = q.shape
    g = q.to(torch.uint8).reshape(*lead, k // FOLD, FOLD, n)
    lo, hi = g[..., : FOLD // 2, :], g[..., FOLD // 2:, :]
    return (lo | (hi << 4)).reshape(*lead, k // 2, n)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., K/2, N]`` -> uint8 values ``[..., K, N]`` (inverse of
    :func:`pack_nibbles`)."""
    *lead, k2, n = packed.shape
    p = packed.reshape(*lead, k2 // (FOLD // 2), FOLD // 2, n)
    return torch.cat([p & 0xF, p >> 4], dim=-2).reshape(*lead, 2 * k2, n)


def pack_crumbs(q: torch.Tensor) -> torch.Tensor:
    """2-bit values ``[..., K, N]`` -> uint8 ``[..., K/4, N]``: ``packed[g*64 + r]``
    holds rows ``g*256 + {0, 64, 128, 192} + r`` in bit pairs 0-1 / 2-3 / 4-5 / 6-7."""
    *lead, k, n = q.shape
    g = q.to(torch.uint8).reshape(*lead, k // FOLD, 4, FOLD // 4, n)
    out = g[..., 0, :, :] | (g[..., 1, :, :] << 2) | (g[..., 2, :, :] << 4) \
        | (g[..., 3, :, :] << 6)
    return out.reshape(*lead, k // 4, n)


def unpack_crumbs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., K/4, N]`` -> uint8 2-bit values ``[..., K, N]``."""
    *lead, k4, n = packed.shape
    p = packed.reshape(*lead, k4 // (FOLD // 4), FOLD // 4, n)
    parts = [(p >> (2 * j)) & 0x3 for j in range(4)]
    return torch.cat(parts, dim=-2).reshape(*lead, 4 * k4, n)


# ---------------------------------------------------------------------------
# quantizers (bit-exact with the JAX package's numpy reference quantizers)
# ---------------------------------------------------------------------------

def _roundf(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C roundf); torch.round rounds half to even."""
    return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))


def _kernel_f32(w: torch.Tensor, align: int, fmt: str) -> torch.Tensor:
    if w.dim() != 2:
        raise ValueError(f"expected 2-D kernel [K, N], got shape {tuple(w.shape)}")
    if w.shape[0] % align:
        raise ValueError(f"{fmt} requires K % {align} == 0, got K={w.shape[0]}")
    return w.float()


def _signed_absmax(blocks: torch.Tensor) -> torch.Tensor:
    """Per block (axis 1) the value of largest magnitude, sign kept; ties go to
    the first index, as numpy's argmax."""
    idx = blocks.abs().argmax(dim=1, keepdim=True)
    return torch.gather(blocks, 1, idx)[:, 0, :]


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division wherever ``x`` lies.  PyTorch's
    CUDA kernel turns a division by a Python number into a multiplication by
    its reciprocal, which rounds differently (x / 127 and x * (1 / 127) part
    in the last bit); a divisor tensor on x's device keeps the true division
    of the CPU and of numpy."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d where d != 0, else 0."""
    return torch.where(d != 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.zeros_like(d))


def quantize_q8_0(w: torch.Tensor) -> QuantTensor:
    """``d = amax/127``, ``q = roundf(x/d)``."""
    w = _kernel_f32(w, BLOCK, "q8_0")
    k, n = w.shape
    blocks = w.reshape(k // BLOCK, BLOCK, n)
    d = _div(blocks.abs().amax(dim=1), 127.0)                # [K/32, N]
    inv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), torch.zeros_like(d))
    q = _roundf(blocks * inv[:, None, :]).clamp(-127, 127).to(torch.int8)
    return QuantTensor("q8_0", (k, n), q.reshape(k, n), d.to(torch.float16))


def quantize_q4_0(w: torch.Tensor) -> QuantTensor:
    """``d = signed_absmax / -8``, ``q = clip(floor(x/d + 8.5), 0, 15)``."""
    w = _kernel_f32(w, FOLD, "q4_0")
    k, n = w.shape
    blocks = w.reshape(k // BLOCK, BLOCK, n)
    d = _div(_signed_absmax(blocks), -8.0)
    q = torch.floor(blocks * _safe_inv(d)[:, None, :] + 8.5).clamp(0.0, 15.0)
    return QuantTensor("q4_0", (k, n), pack_nibbles(q.to(torch.uint8).reshape(k, n)),
                       d.to(torch.float16))


def quantize_q4_k(w: torch.Tensor) -> QuantTensor:
    """Per 32-block ``x ~ d_b * q - min_b`` (q in 0..15, min_b >= 0); per
    256-super-block ``d_b = super * ls``, ``min_b = super_min * lm`` (6-bit)."""
    w = _kernel_f32(w, SUPER, "q4_k")
    k, n = w.shape
    nb, ns, sub = k // BLOCK, k // SUPER, SUPER // BLOCK
    blocks = w.reshape(nb, BLOCK, n)
    mn = torch.clamp(blocks.amin(dim=1), max=0.0)
    d_b = _div(blocks.amax(dim=1) - mn, 15.0)
    min_b = -mn
    d_sup = _div(d_b.reshape(ns, sub, n).amax(dim=1), 63.0)
    m_sup = _div(min_b.reshape(ns, sub, n).amax(dim=1), 63.0)
    d_rep = torch.repeat_interleave(d_sup, sub, dim=0)
    m_rep = torch.repeat_interleave(m_sup, sub, dim=0)
    zero = torch.zeros_like(d_b)
    ls = torch.where(d_rep > 0, _roundf(d_b / torch.clamp(d_rep, min=1e-30)), zero)
    lm = torch.where(m_rep > 0, _roundf(min_b / torch.clamp(m_rep, min=1e-30)), zero)
    ls = ls.clamp(0, 63).to(torch.uint8)
    lm = lm.clamp(0, 63).to(torch.uint8)
    # values against the quantized effective scales
    d_eff = d_rep * ls.float()
    m_eff = m_rep * lm.float()
    inv = torch.where(d_eff > 0, 1.0 / torch.clamp(d_eff, min=1e-30), zero)
    q = _roundf((blocks + m_eff[:, None, :]) * inv[:, None, :]).clamp(0.0, 15.0)
    return QuantTensor("q4_k", (k, n), pack_nibbles(q.to(torch.uint8).reshape(k, n)),
                       sub_scales=ls, sub_mins=lm, super_scales=d_sup.to(torch.float16),
                       super_mins=m_sup.to(torch.float16))


def quantize_q6_k(w: torch.Tensor) -> QuantTensor:
    """Per 16-block ``x ~ d_eff * (q - 32)`` (q in 0..63); per 256-super-block
    ``d_eff = super * ls`` (ls int8)."""
    w = _kernel_f32(w, SUPER, "q6_k")
    k, n = w.shape
    nb, ns, sub = k // SUB16, k // SUPER, SUPER // SUB16
    blocks = w.reshape(nb, SUB16, n)
    d_b = _div(_signed_absmax(blocks), -32.0)
    d_sup = _div(d_b.abs().reshape(ns, sub, n).amax(dim=1), 127.0)
    d_rep = torch.repeat_interleave(d_sup, sub, dim=0)
    ls = torch.where(d_rep > 0, _roundf(d_b / torch.clamp(d_rep, min=1e-30)),
                     torch.zeros_like(d_b)).clamp(-127, 127).to(torch.int8)
    d_eff = d_rep * ls.float()
    q = (_roundf(blocks * _safe_inv(d_eff)[:, None, :]).clamp(-32.0, 31.0) + 32.0)
    q = q.to(torch.uint8).reshape(k, n)
    return QuantTensor("q6_k", (k, n), pack_nibbles(q & 0xF), data_hi=pack_crumbs(q >> 4),
                       sub_scales=ls, super_scales=d_sup.to(torch.float16))


_QUANTIZERS = {"q8_0": quantize_q8_0, "q4_0": quantize_q4_0, "q4_k": quantize_q4_k,
               "q6_k": quantize_q6_k}


def quantize(w: torch.Tensor, fmt: str) -> QuantTensor:
    if fmt not in _QUANTIZERS:
        raise ValueError(f"unknown quant format: {fmt}")
    return _QUANTIZERS[fmt](w)


def supported_format_for(k: int, fmt: str) -> str:
    """Downgrade ``fmt`` to what a K of ``k`` supports: the 4-bit formats need
    K % 256 == 0 (fold packing), else q8_0; q8_0 needs K % 32 == 0, else bf16."""
    if fmt in ("f32", "bf16", "f16"):
        return fmt
    if fmt in FOUR_BIT:
        if k % FOLD == 0:
            return fmt
        fmt = "q8_0"
    if k % BLOCK == 0:
        return fmt
    return "bf16"


# ---------------------------------------------------------------------------
# dequantization (bit-exact with the JAX package's dequantize_np in f32)
# ---------------------------------------------------------------------------

def _rows(s: torch.Tensor, reps: int) -> torch.Tensor:
    return torch.repeat_interleave(s.float(), reps, dim=-2)


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the weight ``[K, N]`` (``[L, K, N]`` if stacked) in ``dtype``:
    dequant in f32, one rounding to ``dtype``."""
    if qt.fmt == "q8_0":
        return (qt.data.float() * _rows(qt.scales, BLOCK)).to(dtype)
    if qt.fmt == "q4_0":
        q = unpack_nibbles(qt.data).float() - 8.0
        return (q * _rows(qt.scales, BLOCK)).to(dtype)
    if qt.fmt == "q4_k":
        sub = SUPER // BLOCK
        d_eff = _rows(qt.super_scales, sub) * qt.sub_scales.float()
        m_eff = _rows(qt.super_mins, sub) * qt.sub_mins.float()
        q = unpack_nibbles(qt.data).float()
        return (q * _rows(d_eff, BLOCK) - _rows(m_eff, BLOCK)).to(dtype)
    if qt.fmt == "q6_k":
        q = (unpack_nibbles(qt.data) | (unpack_crumbs(qt.data_hi) << 4)).float() - 32.0
        d_eff = _rows(qt.super_scales, SUPER // SUB16) * qt.sub_scales.float()
        return (q * _rows(d_eff, SUB16)).to(dtype)
    raise ValueError(f"unknown quant format: {qt.fmt}")
