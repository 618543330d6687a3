"""int8-activation q8_0 matmul for decode-shaped activations: CUDA kernel
wrapper, its plain PyTorch version, the per-row activation quantizer and the
kernel's launch plan.

Kernel: ``csrc/qmm_int8.cu`` (hand-written for sm_90a) replaces
``acestep_tpu/ops/pallas/qmm.py:608 _int8_core_kernel`` (via ``qmm_int8_act``,
:385).  Activations are quantized per row to int8 (one exact f32 scale a row,
qmm.py:406-411); each 32-row block of K gives an exact int32 partial of
int8 x int8 products, which is scaled by the weight's f32 block scale and added
to an f32 accumulator in K order; the row scale multiplies the sum once and the
result is rounded to bf16.  The int32 partial of a block is exact in f32
(|p| <= 127^2 * 32 < 2^24), so the plain version forms all of them with one
f32 batched matmul and then adds the terms in K order, and the kernel gives
its bits.

One launch a call: the quantizer is folded into the kernel.  A column tile is
one thread-block cluster that splits K (:func:`int8_plan` picks the tile width
and the split, and the kernel checks them), and each block streams its K range
through a cp.async ring and quantizes it a step ahead.  Every M <= 16, K % 32
== 0 and N % 128 == 0 has a plan: an unsplit tile's shared memory does not
grow with K.  Layer ``li`` of a stacked weight is read in place
through ``qmm.field_ptrs`` (base plus ``li`` layer strides, checked once per
weight object), so the wrapper makes no view and allocates only the output.

Opt-in (the JAX package's ``ACESTEP_TPU_INT8_ACT=1``): ``ops/cuda/qmm.qmm_nd``
routes a q8_0 weight here when the flattened M is at most ``MAX_M`` and N is a
multiple of 128.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``INT8`` (``_build.Counted``) counts launches, and by
``(M, K, N)``.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Optional, Tuple

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.ops.cuda import qmm as _qmm
from acestep_tpu_torch.quant import BLOCK, QuantTensor

MAX_M = 16           # the JAX package's INT8_ACT_MAX_M
N_ALIGN = 128        # qmm_int8_act's smallest column tile (else its bf16 fallback)
INT8 = _build.Counted("int8_act_qmm", "acestep_tpu_torch/csrc/qmm_int8.cu",
                      "acestep_tpu/ops/pallas/qmm.py:608")

# the kernel's plan: column tiles of TILES_N columns, K split over at most
# MAX_SPLITS blocks of one cluster, at least SMS blocks where the shape allows
# it; a block streams its K range in steps of at most STEP 32-blocks through a
# ring of at most two steps
TILES_N = (128, 64, 32)
MAX_SPLITS = 8
STEP = 8
SMEM_MAX = 200 * 1024        # csrc/qmm_int8.cu SMEM_MAX
SMS = 132
# x, x_f32, w, scales, out, M, N, K, bn, splits, stream
_SLOTS = struct.Struct("<11q")


def int8_smem(m: int, k: int, bn: int, splits: int) -> int:
    """Dynamic shared memory of one block (bytes), as csrc/qmm_int8.cu's
    ``layout``: the ring of weight steps and their scales, the ring of xq
    steps, the terms (of the columns the block owns, or of one step at one
    split), and two [16] f32 rows."""
    nkb = k // BLOCK
    per = -(-nkb // splits)
    step = min(STEP, per)
    ring = min(2, -(-per // step))
    xq = -(-(ring * m * step * BLOCK) // 16) * 16
    terms = nkb * m * (bn // splits) if splits > 1 else STEP * m * bn
    return ring * step * (BLOCK * bn + bn * 4) + xq + terms * 4 + 2 * MAX_M * 4


@functools.lru_cache(maxsize=None)
def int8_plan(m: int, k: int, n: int) -> Tuple[int, int]:
    """``(bn, splits)`` of the kernel for ``x [m, k]`` against W ``[k, n]``,
    among the column tiles (128, 64, 32) and splits (1, 2, 4, 8; whole runs of
    32-blocks, none empty) whose shared memory fits: the widest tile, then
    the fewest splits, that reach SMS blocks; where none does, the most
    blocks (the widest tile of equals).  A split's terms grow with K, so a
    long K at M near 16 takes a narrower tile (the 4B planner's down_proj,
    K 9728, at M 10-16: 64 columns in 8 splits)."""
    if not 1 <= m <= MAX_M or k < BLOCK or k % BLOCK or n < N_ALIGN or n % N_ALIGN:
        raise ValueError(f"int8_plan: no plan for x [{m}, {k}] @ W [{k}, {n}] "
                         f"(M 1..{MAX_M}, K % {BLOCK} == 0, N % {N_ALIGN} == 0)")
    nkb = k // BLOCK
    splits = [s for s in (1, 2, 4, 8)
              if s <= min(nkb, MAX_SPLITS) and math.ceil(nkb / math.ceil(nkb / s)) == s]
    fits = [(bn, s) for bn in TILES_N for s in splits
            if int8_smem(m, k, bn, s) <= SMEM_MAX]        # (32, 1) fits at every K
    return next(((bn, s) for bn, s in fits if n // bn * s >= SMS),
                max(fits, key=lambda p: (n // p[0] * p[1], p[0])))


def quantize_rows(x: torch.Tensor):
    """Per-row int8 quantization of activations [M, K] -> (xq int8 [M, K],
    xs f32 [M]) as qmm.py:406-411: ``xs = amax / 127``, ``inv = 1 / max(xs,
    1e-30)`` (0 for a zero row), round half to even, clip to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    # a true division: a CUDA tensor divided by a Python scalar is computed as
    # a product with its reciprocal, which can differ in the last bit
    xs = amax / torch.full_like(amax, 127.0)
    inv = torch.where(xs > 0, 1.0 / torch.clamp(xs, min=1e-30), torch.zeros_like(xs))
    xq = torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    return xq, xs[:, 0]


def qmm_int8_act_plain(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x [M, K]`` against q8_0
    ``qt [K, N]`` -> bf16 [M, N]."""
    k, n = qt.shape
    m = x.shape[0]
    xq, xs = quantize_rows(x)
    nkb = k // BLOCK
    # exact int32 partials of every 32-block, [K/32, M, N]
    p = torch.bmm(xq.float().reshape(m, nkb, BLOCK).transpose(0, 1),
                  qt.data.float().reshape(nkb, BLOCK, n))
    s = qt.scales.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for kb in range(nkb):
        acc = acc + p[kb] * s[kb]
    return (acc * xs[:, None]).to(torch.bfloat16)


def _launch(x: torch.Tensor, qt: QuantTensor, li: Optional[int] = None) -> torch.Tensor:
    m, k = x.shape
    kk, n = qt.shape
    if qt.fmt != "q8_0" or k != kk or k % BLOCK or n % N_ALIGN or m > MAX_M:
        raise ValueError(f"qmm_int8_act: x [{m}, {k}] against {qt.fmt} {qt.shape} (q8_0, "
                         f"M <= {MAX_M}, K % {BLOCK} == 0, N % {N_ALIGN} == 0)")
    dev = x.device
    w_ptr, s_ptr = _qmm.field_ptrs(qt, dev, li)
    if m == 0:
        return torch.empty((0, n), dtype=torch.bfloat16, device=dev)
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        x = x.float().contiguous()
    bn, splits = int8_plan(m, k, n)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = _build.lib().acestep_qmm_int8(_SLOTS.pack(
        x.data_ptr(), x.dtype is torch.float32, w_ptr, s_ptr, out.data_ptr(), m, n, k, bn,
        splits, _build.stream_ptr(x)))
    _build.check("acestep_qmm_int8", err)
    INT8.count((m, k, n))
    return out


def qmm_int8_act(x: torch.Tensor, qt: QuantTensor, li: Optional[int] = None) -> torch.Tensor:
    """``x [M, K]`` (M <= 16) against q8_0 ``qt [K, N]`` (N % 128 == 0) with
    int8 activations -> bf16 [M, N] (with ``li``: layer ``li`` of a stacked
    weight, read in place on the card)."""
    if x.device.type == "cpu":
        return qmm_int8_act_plain(x, qt if li is None else qt.layer(li))
    if x.device.type != "cuda":
        raise ValueError(f"qmm_int8_act: unsupported device {x.device}")
    return _launch(x, qt, li)
