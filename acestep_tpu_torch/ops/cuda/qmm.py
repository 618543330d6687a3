"""Dequant-matmuls for every quant format: the CUDA kernel wrapper, its plain
PyTorch version and the 2-D / n-D / layer-stacked entry points.

One kernel source, hand-written for sm_90a (csrc/qmm_wgmma.cu: bf16 wgmma with
the dequantized weight as the register A operand, x by TMA into a ring of
shared-memory stages, f32 accumulation), one dequant step per format:

  q8_0  replaces acestep_tpu/ops/pallas/qmm.py:147 _q8_kernel
  q4_0  replaces qmm.py:164 _q4_0_kernel
  q4_k  replaces qmm.py:187 _q4_k_kernel
  q6_k  replaces qmm.py:208 _q6_k_kernel

Its tile height and K split are chosen per shape by :func:`wgmma_plan`.  Each
is reached through ``qmm_pallas`` / ``qmm_pallas_nd`` and, for the DiT's
layer-stacked weights, ``qmm_pallas_stacked`` (scalar-prefetched layer index):
here the stacked form passes the base pointers of layer ``li`` to the same
kernel (:func:`field_ptrs`: base plus ``li`` layer strides, checked once per
weight object), so no per-layer weight copy, nor view, is made either.  The
kernel streams the quantized fields as stored and dequantizes them in
registers, so device memory never holds a bf16 copy of W.

With ``int8_act`` (the JAX package's ``ACESTEP_TPU_INT8_ACT=1``), the n-D and
stacked entry points send a q8_0 weight with a flattened M of at most 16 to

  int8  csrc/qmm_int8.cu  replaces qmm.py:608 _int8_core_kernel (ops/cuda/qmm_int8.py)

as ``qmm_pallas_nd`` does (qmm.py:348-367), unless N % 128 != 0, where the JAX
``qmm_int8_act`` falls back to a bf16 dequant matmul: that is the q8_0 kernel
here.  The int8 route returns bf16 and a bias is added after it in f32, with a
second rounding, as the JAX ``linear`` does after its kernel.

Numerics (the JAX package's, qmm.py:18-19): dequant in f32, one rounding to
bf16, f32 accumulation; the bias is added in f32 before the one output rounding.

Dispatch on ``qt.fmt``: a CPU tensor takes :func:`qmm_plain`; a CUDA tensor
launches the format's kernel or raises.  Each format has its own entry in
:data:`KERNELS`: ``launches`` counts its launches, ``shapes`` counts them by
``(M, K, N)``, so a run can show which kernels and shapes its path used.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
import struct
from typing import Optional, Tuple

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.cuda import qmm_int8 as _int8
from acestep_tpu_torch.quant import BLOCK, FOLD, SUB16, SUPER, QuantTensor, dequantize


@dataclasses.dataclass(kw_only=True)
class Kernel(_build.Counted):
    """One format's kernel: its counts (``Counted``), its number in the C
    entry point's slots and the fields it reads."""

    fmt_id: int
    # (field, dtype, K rows per stored row) in the slots' order
    fields: tuple

    def __post_init__(self):
        self.getter = operator.attrgetter(*(f for f, _, _ in self.fields))
        # format, x, the fields, bias, out, M, N, K, out_bf16, bm, splits, stream
        self.slots = struct.Struct(f"<{len(self.fields) + 11}q")


_U8, _I8, _F32 = torch.uint8, torch.int8, torch.float32
_SRC = "acestep_tpu_torch/csrc/qmm_wgmma.cu"
_PALLAS = "acestep_tpu/ops/pallas/qmm.py"
KERNELS = {
    "q8_0": Kernel("q8_0_qmm", _SRC, f"{_PALLAS}:147", fmt_id=0,
                   fields=(("data", _I8, 1), ("scales", _F32, BLOCK))),
    "q4_0": Kernel("q4_0_qmm", _SRC, f"{_PALLAS}:164", fmt_id=1,
                   fields=(("data", _U8, 2), ("scales", _F32, BLOCK))),
    "q4_k": Kernel("q4_k_qmm", _SRC, f"{_PALLAS}:187", fmt_id=2,
                   fields=(("data", _U8, 2), ("sub_scales", _U8, BLOCK),
                           ("sub_mins", _U8, BLOCK), ("super_scales", _F32, SUPER),
                           ("super_mins", _F32, SUPER))),
    "q6_k": Kernel("q6_k_qmm", _SRC, f"{_PALLAS}:208", fmt_id=3,
                   fields=(("data", _U8, 2), ("data_hi", _U8, 4), ("sub_scales", _I8, SUB16),
                           ("super_scales", _F32, SUPER))),
}
# K a multiple of this, per format (the fold-256 packing of the 4-bit ones)
K_ALIGN = {"q8_0": BLOCK, "q4_0": FOLD, "q4_k": FOLD, "q6_k": FOLD}

# the kernel's blocks: TILE_N weight columns and BM x rows, over K in steps of
# STEP rows; the K splits of a tile are one thread-block cluster
TILE_N = 128
STEP = 128
MAX_SPLITS = 8             # the portable cluster size
SMS = 132                  # streaming multiprocessors of one H100 SXM


def ideal_clusters(fmt: str, bm: int, splits: int) -> int:
    """Clusters of ``splits`` blocks the card would hold at once if any SMs
    could form one: the blocks an SM holds (two at BM = 16, else one) times
    SMS, over ``splits``."""
    return (2 if bm == 16 else 1) * SMS // splits


@functools.lru_cache(maxsize=None)
def device_clusters(fmt: str, bm: int, splits: int) -> int:
    """Clusters of ``splits`` blocks of the format's kernel at ``bm`` x rows
    that the card holds at once (cudaOccupancyMaxActiveClusters): a cluster
    takes SMs of one GPC, so fewer than :func:`ideal_clusters` can fit."""
    n = _build.lib().acestep_qmm_clusters(KERNELS[fmt].fmt_id, bm, splits)
    if n <= 0:
        raise RuntimeError(f"qmm: no cluster of {splits} {fmt} blocks (bm {bm}) fits the card")
    return n


@functools.lru_cache(maxsize=None)
def wgmma_plan(fmt: str, m: int, k: int, n: int,
               clusters=ideal_clusters) -> Tuple[int, int]:
    """``(bm, splits)`` of the kernel for ``x [m, k] @ W [k, n]`` in ``fmt``:
    ``bm`` x rows per block (16, 64 or 128: the wgmma width) and the number of
    K splits.  The tiles alone fill the card at the decoder's M; where they
    would leave more than half of the SMs idle (small M: bound by bytes), K is
    split in whole steps, every split non-empty, at most MAX_SPLITS a tile and
    one block per SM in all.  The splits of a tile are one cluster that adds
    their partial tiles in its blocks' shared memory (no bytes beside the
    weight's, no second launch).  Of the split counts, the plan takes the one
    whose blocks run the fewest steps one after the other: steps per split
    times the waves in which the card runs the tiles' clusters
    (``clusters(fmt, bm, splits)`` at once), the fewest splits among equals."""
    align = K_ALIGN.get(fmt)
    if align is None or m < 1 or n < 1 or k < align or k % align:
        raise ValueError(f"wgmma_plan: no plan for x [{m}, {k}] @ {fmt} W [{k}, {n}] "
                         f"(M, N >= 1, K a positive multiple of {align})")
    bm = 16 if m <= 16 else 64 if m <= 64 else 128
    tiles = math.ceil(n / TILE_N) * math.ceil(m / bm)
    steps = math.ceil(k / STEP)
    if tiles > SMS // 2:
        return bm, 1
    best = (steps, 1)
    for splits in range(2, min(steps, SMS // tiles, MAX_SPLITS) + 1):
        per = math.ceil(steps / splits)
        if math.ceil(steps / per) != splits:            # a split would be empty
            continue
        best = min(best, (per * math.ceil(tiles / clusters(fmt, bm, splits)), splits))
    return bm, best[1]


def qmm_plain(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernels' function in plain PyTorch: ``x [M, K] @ dequant(qt) [K, N]``."""
    wd = dequantize(qt, torch.bfloat16).float()
    y = x.to(torch.bfloat16).float() @ wd
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _check_fields(qt: QuantTensor, tensors, device):
    """(base pointers, layer strides in bytes) of the kernel's fields, after
    checking their type, shape, layout and device."""
    k, n = qt.shape
    lead = (qt.num_layers,) if qt.stacked else ()
    bases, strides = [], []
    for (field, dtype, rows_per), a in zip(KERNELS[qt.fmt].fields, tensors):
        want = lead + (k // rows_per, n)
        if a is None or a.dtype != dtype or tuple(a.shape) != want:
            raise ValueError(
                f"qmm: {qt.fmt} field {field} must be {dtype} {list(want)} "
                "(f32 scales: pre-cast them once), got "
                f"{None if a is None else (a.dtype, tuple(a.shape))}")
        if not a.is_contiguous() or a.device != device:
            raise ValueError(f"qmm: {qt.fmt} field {field} must be contiguous and on "
                             f"{device}")
        bases.append(a.data_ptr())
        strides.append((k // rows_per) * n * a.element_size())
    return bases, strides


def field_ptrs(qt: QuantTensor, device: torch.device, li: Optional[int] = None):
    """The data pointers of the format kernel's fields, in its entry point's
    order.  Layer ``li`` of a stacked weight is each field's base pointer plus
    ``li`` layer strides: no view is made.  The checks run once per weight
    object and device; the result (and each layer's pointers) is kept on the
    object beside the field tensors it was made from, and made anew when one
    of them is replaced."""
    tensors = KERNELS[qt.fmt].getter(qt)
    memo = qt.__dict__.get("_kernel_fields")
    if memo is None or memo[0] != device or not all(map(operator.is_, memo[1], tensors)):
        memo = (device, tensors, *_check_fields(qt, tensors, device),
                qt.num_layers if qt.stacked else 0, {})
        qt.__dict__["_kernel_fields"] = memo
    bases, strides, layers, by_layer = memo[2:]
    if li is None:
        if layers:
            raise ValueError("qmm: a stacked weight needs a layer index")
        return bases
    ptrs = by_layer.get(li)
    if ptrs is None:
        if not layers:
            raise ValueError("qmm: a layer index needs a stacked weight")
        if not -layers <= li < layers:
            raise IndexError(f"qmm: layer {li} of a {layers}-layer weight")
        ptrs = by_layer[li] = [b + (li % layers) * st for b, st in zip(bases, strides)]
    return ptrs


def _launch(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor],
            out_dtype, li: Optional[int] = None) -> torch.Tensor:
    kern = KERNELS[qt.fmt]
    m, k = x.shape
    kk, n = qt.shape
    align = K_ALIGN[qt.fmt]
    if k != kk or k % align:
        raise ValueError(f"qmm: x [{m}, {k}] against {qt.fmt} weight {qt.shape} "
                         f"(K must be a multiple of {align})")
    dev = x.device
    ptrs = field_ptrs(qt, dev, li)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmm: output dtype {out_dtype} not supported")
    bias_ptr = 0
    if bias is not None:
        bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"qmm: bias must be [{n}], got {tuple(bias.shape)}")
        bias_ptr = bias.data_ptr()
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        x = x.to(torch.bfloat16).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    x_ptr = x.data_ptr()
    if x_ptr % 16:
        x = x.clone()                  # the kernel reads x in 16-byte pieces
        x_ptr = x.data_ptr()
    bm, splits = wgmma_plan(qt.fmt, m, k, n, device_clusters)
    err = _build.lib().acestep_qmm(kern.slots.pack(
        kern.fmt_id, x_ptr, *ptrs, bias_ptr, out.data_ptr(), m, n, k,
        out_dtype is torch.bfloat16, bm, splits, _build.stream_ptr(x)))
    _build.check(kern.name, err)
    kern.count((m, k, n))
    return out


def wgmma_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [64, 64] @ b [128, 64]^T`` (bf16 in, f32 out) through one plain
    wgmma tile that uses the dequant-matmul's descriptor, swizzle, A fragment
    and accumulator layouts (their check against ``torch.matmul``)."""
    if a.shape != (64, 64) or b.shape != (128, 64) or a.device.type != "cuda":
        raise ValueError("wgmma_tile: a [64, 64] and b [128, 64] on a CUDA device")
    a, b = a.to(torch.bfloat16).contiguous(), b.to(torch.bfloat16).contiguous()
    out = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    _build.check("acestep_wgmma_tile_check", _build.lib().acestep_wgmma_tile_check(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), _build.stream_ptr(a)))
    return out


def qmm(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
        out_dtype=torch.bfloat16, li: Optional[int] = None) -> torch.Tensor:
    """``x [M, K] @ dequant(qt) [K, N] (+ bias) -> [M, N]`` in ``out_dtype``
    (with ``li``: layer ``li`` of a stacked weight)."""
    if x.device.type == "cpu":
        return qmm_plain(x, qt if li is None else qt.layer(li), bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x.device}")
    return _launch(x, qt, bias, out_dtype, li)


def _qmm_2d(x: torch.Tensor, qt: QuantTensor, bias, out_dtype, int8_act: bool,
            li: Optional[int] = None):
    if (int8_act and qt.fmt == "q8_0" and x.shape[0] <= _int8.MAX_M
            and qt.shape[1] % _int8.N_ALIGN == 0):
        y = _int8.qmm_int8_act(x, qt, li)
        if bias is None:
            return y.to(out_dtype)
        return (y.float() + bias.float()).to(out_dtype)
    return qmm(x, qt, bias, out_dtype, li)


def qmm_nd(x: torch.Tensor, qt: QuantTensor, bias: Optional[torch.Tensor] = None,
           out_dtype=torch.bfloat16, int8_act: bool = False) -> torch.Tensor:
    """``[..., K] @ qt [K, N] -> [..., N]``; ``int8_act`` as the module
    docstring says."""
    lead = x.shape[:-1]
    y = _qmm_2d(x.reshape(-1, x.shape[-1]), qt, bias, out_dtype, int8_act)
    return y.reshape(*lead, qt.shape[1])


def qmm_stacked(x: torch.Tensor, qt: QuantTensor, li: int,
                bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [M, K] @ dequant(qt[li])``: layer ``li`` of a stacked ``[L, K, N]``
    weight, read in place (no per-layer copy)."""
    if not qt.stacked:
        raise ValueError("qmm_stacked: weight has no layer axis")
    return qmm(x, qt, bias, out_dtype, li)


def qmm_stacked_nd(x: torch.Tensor, qt: QuantTensor, li: int,
                   bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16,
                   int8_act: bool = False) -> torch.Tensor:
    """``[..., K] @ dequant(qt[li])``: layer ``li`` of a stacked ``[L, K, N]``
    weight, read in place (no per-layer copy); ``int8_act`` as in
    :func:`qmm_nd`."""
    if not qt.stacked:
        raise ValueError("qmm_stacked_nd: weight has no layer axis")
    lead = x.shape[:-1]
    y = _qmm_2d(x.reshape(-1, x.shape[-1]), qt, bias, out_dtype, int8_act, li)
    return y.reshape(*lead, qt.shape[1])
