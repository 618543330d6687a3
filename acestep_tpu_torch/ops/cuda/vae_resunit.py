"""Fused Oobleck residual unit and dilation-1/3/9 trio: CUDA kernel wrappers
and their plain PyTorch versions.

Kernels: ``csrc/vae_resunit.cu`` (hand-written for sm_90a).
  * ``fused_res_unit`` replaces ``acestep_tpu/ops/pallas/vae_resunit.py:52
    _kernel`` (via ``fused_res_unit``, :190): one unit
    ``x + conv1x1(snake(conv7_dil(snake(x))))``; the main path runs it on the
    256-channel decoder block (d = 1, 3, 9).
  * ``fused_res_trio`` replaces ``vae_resunit.py:255 _trio_kernel`` (via
    ``fused_res_trio``, :371): the three chained units of a 128-channel block
    in one launch.

Bound on the H100: operations (2*8*C*C flops per row against 8*C bytes per
unit).  The convs run on tensor cores in error-compensated TF32: every operand
is split into a TF32 ``hi`` and the TF32 rounding of its remainder ``lo``, and
the f32 accumulators take hi*hi + lo*hi + hi*lo (about 22 significant bits,
f32's 1e-4 bound holds; one TF32 product alone does not).

The kernel takes its weights as shared-memory stage images (``stage_images``):
per unit 8 taps (conv1's 7, then conv2) x C/32 chunks of 32 input channels x
(hi, lo), each the [C couts, 32 ci] slab of W^T, the input channels of every
group of 8 permuted (slot u <-> ci 2u, slot 4 + u <-> ci 2u + 1) and the 16-byte
chunks of each 128-byte row swizzled (chunk q of row co at q ^ (co % 8)).
``unit_operands`` / ``trio_operands`` build them, with the plain version's
tensors (snake alpha/beta exponentiated here, as the JAX wrapper does), once per
parameter dict and keep them while its tensors live.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  With grad on and a tensor that requires it, the kernel runs inside
:class:`KernelGrad`, whose backward is the plain version's autograd (the JAX
package's backward is XLA, not Pallas).  ``UNIT`` / ``TRIO`` (``_build.Counted``) count launches, and by
``(N, L, C[, dilation])``; the single-pass TF32 builds (``launch_*_tf32``, a
planted fault for the checks and an ablation for the timing tool) count none.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from acestep_tpu_torch.ops.cuda import _build

SOURCE = "acestep_tpu_torch/csrc/vae_resunit.cu"
# launches counted by (N, L, C, dilation) / (N, L, C)
UNIT = _build.Counted("vae_res_unit", SOURCE, "acestep_tpu/ops/pallas/vae_resunit.py:52")
TRIO = _build.Counted("vae_res_trio", SOURCE, "acestep_tpu/ops/pallas/vae_resunit.py:255")
TRIO_D = (1, 3, 9)
UNIT_CHANNELS = (128, 256)
TRIO_CHANNELS = (128,)
MAX_SMEM = 232448          # bytes of shared memory one block may use on sm_90
TAPS = 8                   # conv1's 7 taps, then conv2 (the kernel's stage order)


def tile_rows(c: int) -> int:
    """Output rows of one block's tile (csrc/vae_resunit.cu Geo::TM)."""
    return 16384 // c


def unit_tensors(p, device=None):
    """A res-unit param dict -> (w1 [7,C,C], b1, w2 [C,C], b2, a1, be1, a2, be2),
    f32 contiguous, with exp() applied to the log-scale snake params."""
    w1 = p["conv1"]["w"]
    c = w1.shape[-1]
    device = device or w1.device

    def f32(t):
        return t.to(device=device, dtype=torch.float32).contiguous()

    def bias(conv):
        b = conv.get("b")
        return torch.zeros(c, dtype=torch.float32, device=device) if b is None else f32(b)

    return (f32(w1), bias(p["conv1"]), f32(p["conv2"]["w"]).reshape(c, c),
            bias(p["conv2"]),
            torch.exp(f32(p["snake1"]["alpha"])), torch.exp(f32(p["snake1"]["beta"])),
            torch.exp(f32(p["snake2"]["alpha"])), torch.exp(f32(p["snake2"]["beta"])))


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    ``cvt.rna.tf32.f32`` on the bit pattern."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """t = hi + lo (+ what TF32 cannot hold): hi = tf32(t), lo = tf32(t - hi)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def stage_images(w1s: torch.Tensor, w2s: torch.Tensor) -> torch.Tensor:
    """Weights [U, 7, C, C] / [U, C, C] (JAX layout [tap, Cin, Cout]) -> the
    kernel's stage images [U, 16 * C / 32, C, 32] f32: stage (tap * C/32 +
    chunk) * 2 + part (0: hi, 1: lo), row co, 16-byte chunk q ^ (co % 8), slot
    4q + e holding ci = 32 * chunk + 8 * (q // 2) + 2 * e + q % 2."""
    u, c = w1s.shape[0], w1s.shape[-1]
    kc = c // 32
    w = torch.cat([w1s, w2s[:, None]], 1).transpose(2, 3)          # [U, 8, co, ci]
    # ci = 32 kc + 8 s + 2 e + h  ->  slot 8 s + 4 h + e (chunk q = 2 s + h)
    w = w.reshape(u, TAPS, c, kc, 4, 4, 2).transpose(-1, -2).reshape(u, TAPS, c, kc, 8, 4)
    rows = torch.arange(c, device=w.device)[:, None]
    idx = torch.arange(8, device=w.device)[None, :] ^ (rows & 7)    # [co, q'] -> q
    w = torch.gather(w, 4, idx[None, None, :, None, :, None].expand_as(w).contiguous())
    hi, lo = tf32_split(w.permute(0, 1, 3, 2, 4, 5).contiguous())    # [U, 8, kc, co, 8, 4]
    return torch.stack([hi, lo], 3).reshape(u, TAPS * kc * 2, c, 32).contiguous()


def kernel_vectors(b1, b2, a1, be1, a2, be2) -> torch.Tensor:
    """[U, C] each -> the kernel's [U, 6, C]: the biases, each snake's alpha and
    ib = 1 / (beta + 1e-9) (rounded once, as ``_snake`` rounds it)."""
    return torch.stack([b1, b2, a1, 1.0 / (be1 + 1e-9), a2, 1.0 / (be2 + 1e-9)], 1).contiguous()


@dataclasses.dataclass(frozen=True)
class Operands:
    """One unit's (or a trio's, with a leading axis of 3) tensors in both layouts."""

    plain: tuple                       # unit_tensors' eight (stacked for a trio)
    stages: Optional[torch.Tensor]     # [U, 16 * C / 32, C, 32]: stage_images (CUDA only)
    vec: Optional[torch.Tensor]        # [U, 6, C]: b1, b2, a1, ib1, a2, ib2 (CUDA only)


def _make(per_unit, device, stacked: bool) -> Operands:
    """Operands of the units' ``unit_tensors``: stacked copies (no reference to
    the param tensors, so the cache entry can go with them), the plain ones
    without the leading axis for a unit."""
    stack = tuple(torch.stack([t[i].detach() for t in per_unit]) for i in range(8))
    plain = stack if stacked else tuple(t[0] for t in stack)
    if torch.device(device).type != "cuda":
        return Operands(plain, None, None)
    w1, b1, w2, b2, a1, be1, a2, be2 = stack
    return Operands(plain, stage_images(w1, w2), kernel_vectors(b1, b2, a1, be1, a2, be2))


# prepared operands by (kind, device, ids of the param tensors) ->
# (weakrefs of those tensors, Operands); an entry goes when one of them dies
_PREPARED: dict = {}


def _prepared(kind, units, device, make) -> Operands:
    leaves = [t for u in units for part in ("snake1", "conv1", "snake2", "conv2")
              for t in u[part].values() if t is not None]
    key = (kind, str(torch.device(device)), tuple(id(t) for t in leaves))
    hit = _PREPARED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], leaves)):
        return hit[1]
    ops = make()

    def drop(_ref, key=key):
        _PREPARED.pop(key, None)

    _PREPARED[key] = ([weakref.ref(t, drop) for t in leaves], ops)
    return ops


def unit_operands(p, device=None) -> Operands:
    """A res-unit param dict's operands on ``device`` (made once, then kept)."""
    device = device or p["conv1"]["w"].device
    return _prepared("unit", (p,), device,
                     lambda: _make([unit_tensors(p, device)], device, False))


def trio_operands(units, device=None) -> Operands:
    """(res1, res2, res3)'s operands on ``device``, stacked (made once, then kept)."""
    device = device or units[0]["conv1"]["w"].device
    return _prepared("trio", tuple(units), device,
                     lambda: _make([unit_tensors(u, device) for u in units], device, True))


def _snake(x, a, be):
    return x + (1.0 / (be + 1e-9)) * torch.square(torch.sin(a * x))


def res_unit_plain(x, w1, b1, w2, b2, a1, be1, a2, be2, dilation: int):
    """The unit kernel's function in plain PyTorch; x [N, L, C] f32."""
    s1 = _snake(x, a1, be1).transpose(1, 2)
    y1 = F.conv1d(s1, w1.permute(2, 1, 0), b1, padding=3 * dilation, dilation=dilation)
    s2 = _snake(y1.transpose(1, 2), a2, be2)
    return x + (s2 @ w2 + b2)


def res_trio_plain(x, w1s, b1s, w2s, b2s, a1s, be1s, a2s, be2s):
    """The trio kernel's function: units d=1, 3, 9 in sequence (each unit's conv
    zero-pads at the sequence edges); stacked params carry a leading axis of 3."""
    for i, d in enumerate(TRIO_D):
        x = res_unit_plain(x, w1s[i], b1s[i], w2s[i], b2s[i], a1s[i], be1s[i],
                           a2s[i], be2s[i], d)
    return x


def _check_x(x: torch.Tensor, channels, name: str) -> torch.Tensor:
    if x.dim() != 3 or x.shape[-1] not in channels:
        raise ValueError(f"{name}: x must be [N, L, C] with C in {channels}, "
                         f"got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.to(torch.float32).contiguous()


def _check_ops(ops: Operands, x: torch.Tensor, units: int, name: str) -> None:
    c = x.shape[-1]
    if (ops.stages is None or ops.stages.device != x.device
            or tuple(ops.stages.shape) != (units, TAPS * c // 16, c, 32)):
        raise ValueError(f"{name}: operands not prepared for C={c} on {x.device}")


def _unit(entry: str, x, ops: Operands, dilation: int) -> torch.Tensor:
    x = _check_x(x, UNIT_CHANNELS, "fused_res_unit")
    _check_ops(ops, x, 1, "fused_res_unit")
    n, l, c = x.shape
    lib = _build.lib()
    smem = lib.acestep_vae_res_unit_smem(c, dilation)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_res_unit: dilation {dilation} at C={c} needs {smem} "
                         "bytes of shared memory")
    out = torch.empty_like(x)
    err = getattr(lib, entry)(x.data_ptr(), ops.stages.data_ptr(), ops.vec.data_ptr(),
                              out.data_ptr(), n, l, c, dilation, _build.stream_ptr(x))
    _build.check(entry, err)
    return out


def _trio(entry: str, x, ops: Operands) -> torch.Tensor:
    x = _check_x(x, TRIO_CHANNELS, "fused_res_trio")
    _check_ops(ops, x, 3, "fused_res_trio")
    n, l, c = x.shape
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    sync = torch.zeros(2, dtype=torch.int32, device=x.device)
    err = getattr(_build.lib(), entry)(
        x.data_ptr(), ops.stages.data_ptr(), ops.vec.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), sync.data_ptr(), n, l, c, _build.stream_ptr(x))
    _build.check(entry, err)
    return out


def launch_unit(x: torch.Tensor, ops: Operands, dilation: int) -> torch.Tensor:
    out = _unit("acestep_vae_res_unit", x, ops, dilation)
    UNIT.count(tuple(x.shape) + (dilation,))
    return out


def launch_trio(x: torch.Tensor, ops: Operands) -> torch.Tensor:
    out = _trio("acestep_vae_res_trio", x, ops)
    TRIO.count(tuple(x.shape))
    return out


def launch_unit_tf32(x: torch.Tensor, ops: Operands, dilation: int) -> torch.Tensor:
    """The unit kernel built without the lo products (single-pass TF32)."""
    return _unit("acestep_vae_res_unit_tf32", x, ops, dilation)


def launch_trio_tf32(x: torch.Tensor, ops: Operands) -> torch.Tensor:
    """The trio kernel built without the lo products (single-pass TF32)."""
    return _trio("acestep_vae_res_trio_tf32", x, ops)


class KernelGrad(torch.autograd.Function):
    """A res kernel with a gradient: the forward is ``launch(x)`` (the CUDA
    kernel), the backward recomputes ``plain(x, *tensors)`` under grad and
    returns that graph's vector-Jacobian product for x and every tensor, as
    the JAX wrapper's ``custom_vjp`` recomputes through its XLA copy of the
    kernel's arithmetic (vae_resunit.py:145-187, :347-356).  ``tensors`` are
    the plain version's operands (``unit_tensors``, stacked for a trio); their
    gradients flow on to the param dict through ``unit_tensors``' casts and
    exponentials."""

    @staticmethod
    def forward(ctx, launch, plain, x, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(x, *tensors)
        return launch(x)

    @staticmethod
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip([x, *tensors], need)]
            out = ctx.plain(*ins)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True)
                         if wanted else ())
        out_grads = []
        for t, n in zip(ins, need):
            gr = next(grads) if n else None
            out_grads.append(torch.zeros_like(t) if n and gr is None else gr)
        return (None, None, *out_grads)


def _needs_grad(x: torch.Tensor, units) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for u in units for part in ("snake1", "conv1", "snake2", "conv2")
        for t in u[part].values() if t is not None))


def fused_res_unit(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """One res unit (param dict ``p``) on x [N, L, C]; returns x's dtype.
    Differentiable in x and ``p`` when grad is on and one of them requires it
    (:class:`KernelGrad` on the card)."""
    if _needs_grad(x, (p,)):
        tens = unit_tensors(p, x.device)

        def plain(xx, *tt):
            return res_unit_plain(xx, *tt, dilation)

        if x.device.type == "cpu":
            return plain(x.float(), *tens).to(x.dtype)
        ops = _make([tens], x.device, False)
        return KernelGrad.apply(lambda xx: launch_unit(xx, ops, dilation), plain,
                                x.float(), *tens).to(x.dtype)
    ops = unit_operands(p, x.device)
    if x.device.type == "cpu":
        return res_unit_plain(x.float(), *ops.plain, dilation).to(x.dtype)
    return launch_unit(x, ops, dilation).to(x.dtype)


def fused_res_trio(units, x: torch.Tensor) -> torch.Tensor:
    """Three chained res units (dilations 1, 3, 9); ``units`` = (res1, res2, res3).
    Differentiable as :func:`fused_res_unit`."""
    if _needs_grad(x, units):
        per_unit = [unit_tensors(u, x.device) for u in units]
        tens = tuple(torch.stack([t[i] for t in per_unit]) for i in range(8))
        if x.device.type == "cpu":
            return res_trio_plain(x.float(), *tens).to(x.dtype)
        ops = _make(per_unit, x.device, True)
        return KernelGrad.apply(lambda xx: launch_trio(xx, ops), res_trio_plain,
                                x.float(), *tens).to(x.dtype)
    ops = trio_operands(units, x.device)
    if x.device.type == "cpu":
        return res_trio_plain(x.float(), *ops.plain).to(x.dtype)
    return launch_trio(x, ops).to(x.dtype)
