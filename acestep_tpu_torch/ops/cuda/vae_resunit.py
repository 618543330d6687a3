"""Fused Oobleck residual unit and dilation-1/3/9 trio: CUDA kernel wrappers
and their plain PyTorch versions.

Kernels: ``csrc/vae_resunit.cu`` (hand-written for sm_90a, f32).
  * ``fused_res_unit`` replaces ``acestep_tpu/ops/pallas/vae_resunit.py:52
    _kernel`` (via ``fused_res_unit``, :190): one unit
    ``x + conv1x1(snake(conv7_dil(snake(x))))``; the main path runs it on the
    256-channel decoder block (d = 1, 3, 9).
  * ``fused_res_trio`` replaces ``vae_resunit.py:255 _trio_kernel`` (via
    ``fused_res_trio``, :371): the three chained units of a 128-channel block
    in one pass, intermediates kept on chip.

Bound on the H100: operations (2*8*C*C f32 flops per row against 8*C bytes
per unit).  Each block reads one time tile plus its halo once, keeps every
intermediate in shared memory, and writes the tile once.

Snake alpha/beta are exponentiated here, in the wrapper, as the JAX wrapper
does.  A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``UNIT`` / ``TRIO`` (``_build.Counted``) count launches, and by
``(N, L, C[, dilation])``.
"""

from __future__ import annotations

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


def launch_unit(x: torch.Tensor, tensors, dilation: int) -> torch.Tensor:
    x = _check_x(x, UNIT_CHANNELS, "fused_res_unit")
    n, l, c = x.shape
    lib = _build.lib()
    smem = lib.acestep_vae_res_unit_smem(c, dilation)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_res_unit: dilation {dilation} at C={c} needs {smem} "
                         "bytes of shared memory")
    out = torch.empty_like(x)
    err = lib.acestep_vae_res_unit(x.data_ptr(), *(t.data_ptr() for t in tensors),
                                   out.data_ptr(), n, l, c, dilation, _build.stream_ptr(x))
    _build.check("acestep_vae_res_unit", err)
    UNIT.count((n, l, c, dilation))
    return out


def launch_trio(x: torch.Tensor, stacked) -> torch.Tensor:
    x = _check_x(x, TRIO_CHANNELS, "fused_res_trio")
    n, l, c = x.shape
    out = torch.empty_like(x)
    err = _build.lib().acestep_vae_res_trio(
        x.data_ptr(), *(t.data_ptr() for t in stacked), out.data_ptr(), n, l, c,
        _build.stream_ptr(x))
    _build.check("acestep_vae_res_trio", err)
    TRIO.count((n, l, c))
    return out


def fused_res_unit(p, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """One res unit (param dict ``p``) on x [N, L, C]; returns x's dtype."""
    tensors = unit_tensors(p, x.device)
    if x.device.type == "cpu":
        return res_unit_plain(x.float(), *tensors, dilation).to(x.dtype)
    return launch_unit(x, tensors, dilation).to(x.dtype)


def trio_tensors(units, device=None):
    per_unit = [unit_tensors(u, device) for u in units]
    return tuple(torch.stack([t[i] for t in per_unit]).contiguous() for i in range(8))


def fused_res_trio(units, x: torch.Tensor) -> torch.Tensor:
    """Three chained res units (dilations 1, 3, 9); ``units`` = (res1, res2, res3)."""
    stacked = trio_tensors(units, x.device)
    if x.device.type == "cpu":
        return res_trio_plain(x.float(), *stacked).to(x.dtype)
    return launch_trio(x, stacked).to(x.dtype)
