#!/usr/bin/env python3
"""Times of the VAE res-unit and trio kernels (rows 7 and 8) at a request's
shapes, on the card.

    python3 tools/time_vae_resunit.py [--durations 10 60] [--ablate] [--decodes 3]

Run it from the root of a checkout: it times that checkout's
``acestep_tpu_torch`` with the inputs, timers and bounds of the
``chip_smoke.py`` beside this tool.  For each duration it decodes random
latents of that length (25 frames a second) through the full-width random VAE
in one pass (``pipeline.decode_one_pass`` at the chunk and window batch of
the memory plan), records each shape the two kernels launched and the host-clock
decode time (``vae_compute_time_cost`` of a request: the mean of ``--decodes``
decodes after a warm-up), then times every shape with CUDA events (warm L2):
the kernel, its plain PyTorch version, the same convs as cuDNN f32 calls, and,
with ``--ablate``, the kernel built without the lo products (single-pass TF32,
what the error compensation costs).  Each line has the rate and both bounds:
operations over 495 TFLOP/s for three TF32 products a multiply-add (the
design's arithmetic) and over 67 TFLOP/s f32 (CUDA cores); then the sums per
request, weighted by launches.  The card's name and power limit come first.
Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
FRAMES_PER_S = 25


def _smoke_helpers():
    """This repository's chip_smoke.py as a module of helpers (its functions
    import acestep_tpu_torch when called: the timed checkout's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decode_shapes(vae_params, cfg, frames: int, decodes: int):
    """(unit shapes, trio shapes, mean decode seconds) of one request's decode
    of ``frames`` latent frames."""
    import torch
    from acestep_tpu_torch import memory_planner, pipeline
    from acestep_tpu_torch.config import DiTConfig
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    g = torch.Generator(device="cuda").manual_seed(frames)
    latents = torch.randn((1, frames, cfg.decoder_input_channels), generator=g, device="cuda")
    # the decode chunk and window batch the engine's memory plan gives
    plan = memory_planner.plan_request(DiTConfig(), cfg, memory_planner.tree_bytes(vae_params),
                                       1, frames)

    def run():
        pipeline.decode_one_pass(vae_params, cfg, latents, plan)
        torch.cuda.synchronize()

    run()
    vru.UNIT.reset()
    vru.TRIO.reset()
    run()
    units, trios = dict(vru.UNIT.shapes), dict(vru.TRIO.shapes)
    t0 = time.perf_counter()
    for _ in range(decodes):
        run()
    return units, trios, (time.perf_counter() - t0) / decodes


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--durations", nargs="+", type=float, default=[10.0, 60.0])
    ap.add_argument("--ablate", action="store_true",
                    help="also time the single-pass TF32 build of each kernel")
    ap.add_argument("--decodes", type=int, default=3)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_vae_resunit: no CUDA device", file=sys.stderr)
        return 2
    from acestep_tpu_torch.config import VAEConfig
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.ops.cuda import _build
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke_helpers()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    _build.lib()
    cfg = VAEConfig()
    vae_params = RandomInit(torch.device("cuda"), 0, None).vae(cfg)

    def conv_lib(x, tens, d):
        y = F.conv1d(x.transpose(1, 2), tens[0].permute(2, 1, 0), tens[1], padding=3 * d,
                     dilation=d)
        return F.conv1d(y, tens[2].t()[:, :, None], tens[3])

    for duration in args.durations:
        frames = int(round(duration * FRAMES_PER_S))
        units, trios, decode_s = decode_shapes(vae_params, cfg, frames, args.decodes)
        print(f"== {duration:g} s ({frames} latent frames): vae decode {decode_s:.4f} s "
              f"(host clock, mean of {args.decodes})", flush=True)
        for kind, counts in (("unit", units), ("trio", trios)):
            tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "tf32": 0.0, "bound": 0.0,
                   "bound_f32": 0.0}
            for shape, cnt in sorted(counts.items()):
                n, length, c = shape[:3]
                x = smoke._res_x(n, length, c, 300)
                if kind == "unit":
                    d = shape[3]
                    ops = vru.unit_operands(smoke._unit_params(c, 300), x.device)
                    fns = {"ms": lambda: vru.launch_unit(x, ops, d),
                           "plain": lambda: vru.res_unit_plain(x, *ops.plain, d),
                           "lib": lambda: conv_lib(x, ops.plain, d),
                           "tf32": lambda: vru.launch_unit_tf32(x, ops, d)}
                    units_n = 1
                else:
                    ops = vru.trio_operands(
                        tuple(smoke._unit_params(c, 300 + j) for j in range(3)), x.device)
                    per = [tuple(t[j] for t in ops.plain) for j in range(3)]
                    fns = {"ms": lambda: vru.launch_trio(x, ops),
                           "plain": lambda: vru.res_trio_plain(x, *ops.plain),
                           "lib": lambda: [conv_lib(x, per[j], vru.TRIO_D[j])
                                           for j in range(3)],
                           "tf32": lambda: vru.launch_trio_tf32(x, ops)}
                    units_n = 3
                if not args.ablate:
                    del fns["tf32"]
                got = {k: smoke.cuda_ms(fn) for k, fn in fns.items()}
                (b, by), b32 = smoke.res_bound(n, length, c, units_n)
                got.update(bound=b, bound_f32=b32)
                flops = units_n * 16.0 * n * length * c * c
                extra = (f", single-pass TF32 {got['tf32']:.4f} "
                         f"({flops / got['tf32'] / 1e9:.1f} TFLOP/s)" if "tf32" in got else "")
                print(f"  {kind} {shape} x{cnt}: kernel {got['ms']:.4f} ms "
                      f"({flops / got['ms'] / 1e9:.1f} TFLOP/s, {b / got['ms']:.1%} of the "
                      f"3xTF32 bound {b:.4f} ({by}), f32 bound {b32:.4f}), plain "
                      f"{got['plain']:.4f}, cuDNN f32 {got['lib']:.4f}{extra}", flush=True)
                for key in tot:
                    tot[key] += cnt * got.get(key, 0.0)
            print(f"{kind} per {duration:g} s request: kernel {tot['ms']:.4f} ms, plain "
                  f"{tot['plain']:.4f}, cuDNN f32 {tot['lib']:.4f}, bound {tot['bound']:.4f} "
                  f"(3xTF32), f32 bound {tot['bound_f32']:.4f}"
                  + (f", single-pass TF32 {tot['tf32']:.4f}" if args.ablate else ""),
                  flush=True)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
