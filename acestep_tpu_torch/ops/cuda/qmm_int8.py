"""int8-activation q8_0 matmul for decode-shaped activations: CUDA kernel
wrapper, its plain PyTorch version and the per-row activation quantizer.

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

Opt-in (the JAX package's ``ACESTEP_TPU_INT8_ACT=1``): ``ops/cuda/qmm.qmm_nd``
routes a q8_0 weight here when the flattened M is at most ``MAX_M`` and N is a
multiple of 128.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``INT8`` (``_build.Counted``) counts launches, and by
``(M, K, N)``.
"""

from __future__ import annotations

import torch

from acestep_tpu_torch.ops.cuda import _build
from acestep_tpu_torch.quant import BLOCK, QuantTensor

MAX_M = 16           # the JAX package's INT8_ACT_MAX_M
N_ALIGN = 128        # qmm_int8_act's smallest column tile (else its bf16 fallback)
INT8 = _build.Counted("int8_act_qmm", "acestep_tpu_torch/csrc/qmm_int8.cu",
                      "acestep_tpu/ops/pallas/qmm.py:608")


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


def _launch(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    m, k = x.shape
    kk, n = qt.shape
    if qt.fmt != "q8_0" or k != kk or k % BLOCK or n % N_ALIGN or m > MAX_M:
        raise ValueError(f"qmm_int8_act: x [{m}, {k}] against {qt.fmt} {qt.shape} (q8_0, "
                         f"M <= {MAX_M}, K % {BLOCK} == 0, N % {N_ALIGN} == 0)")
    dev = x.device
    for field, dtype, shape in (("data", torch.int8, (k, n)),
                                ("scales", torch.float32, (k // BLOCK, n))):
        a = getattr(qt, field)
        if a.dtype != dtype or tuple(a.shape) != shape or not a.is_contiguous() \
                or a.device != dev:
            raise ValueError(f"qmm_int8_act: {field} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev} (f32 scales: pre-cast them once), got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    x_f32 = x.dtype != torch.bfloat16
    x = (x.float() if x_f32 else x).contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m,), dtype=torch.float32, device=dev)
    err = _build.lib().acestep_qmm_int8(
        x.data_ptr(), int(x_f32), qt.data.data_ptr(), qt.scales.data_ptr(), xq.data_ptr(),
        xs.data_ptr(), out.data_ptr(), m, n, k, _build.stream_ptr(x))
    _build.check("acestep_qmm_int8", err)
    INT8.count((m, k, n))
    return out


def qmm_int8_act(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """``x [M, K]`` (M <= 16) against q8_0 ``qt [K, N]`` (N % 128 == 0) with
    int8 activations -> bf16 [M, N]."""
    if x.device.type == "cpu":
        return qmm_int8_act_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"qmm_int8_act: unsupported device {x.device}")
    return _launch(x, qt)
