#!/usr/bin/env python3
"""Per-shape times of the port's 4-bit dequant-matmul kernels at the 60 s
request's shapes, on the card.

    python3 tools/time_qmm_shapes.py [--formats q4_k q6_k] [--frames 1536]
                                     [--extra 1536x2048x12288 ...]

Run it from the root of a checkout: it times that checkout's
``acestep_tpu_torch`` (so one call can time two trees, for example a parent
commit unpacked beside the working tree, on one card), with the shapes, inputs
and timers of the ``chip_smoke.py`` beside this tool.
For every (M, K, N) that a batch-1 request with ``--frames`` latent frames
sends to each format's kernel, it prints the kernel's time two ways, both with
CUDA events and warm L2: eager (back-to-back wrapper calls, so a shape whose
device time is below the wrapper's host cost shows the host cost) and as the
replay of a CUDA graph of the same calls (device time only), beside
``torch.matmul`` on the dequantized bf16 weight timed the same two ways, the
bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s) and the rate.
The card's name and power limit come first.  Needs one NVIDIA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")


def _smoke_helpers():
    """This repository's chip_smoke.py as a module of helpers (its functions
    import acestep_tpu_torch when called: the timed checkout's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", nargs="+", default=["q4_k", "q6_k"])
    ap.add_argument("--frames", type=int, default=1536)
    ap.add_argument("--extra", nargs="*", default=[],
                    help="more shapes MxKxN, timed for every format")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_qmm_shapes: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke_helpers()
    from acestep_tpu_torch.config import DiTConfig, QwenConfig
    from acestep_tpu_torch.ops.cuda import qmm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; checkout {os.getcwd()}", flush=True)
    shapes = cs.main_path_shapes(DiTConfig(), QwenConfig(), frames=args.frames)
    extra = [tuple(int(v) for v in e.split("x")) for e in args.extra]
    for fmt in args.formats:
        tot = {"eager": 0.0, "graph": 0.0, "lib_eager": 0.0, "lib_graph": 0.0}
        counted = cs.shapes_by_kernel(fmt, shapes).get(fmt, [])
        for i, shape in enumerate(counted + extra):
            case = cs.QmmCase(fmt, *shape, 200 + i)

            def kern():
                return qmm._launch(case.x, case.qt, None, torch.bfloat16)

            def lib():
                return torch.matmul(case.x, case.wd)

            t = {"eager": cs.cuda_ms(kern, iters=20), "graph": cs.graph_ms(kern),
                 "lib_eager": cs.cuda_ms(lib, iters=20), "lib_graph": cs.graph_ms(lib)}
            b, by = case.bound()
            flops = 2.0 * shape[0] * shape[1] * shape[2]
            print(f"{fmt} M={shape[0]} K={shape[1]} N={shape[2]}: kernel eager "
                  f"{t['eager']:.4f} ms, graph {t['graph']:.4f} ms "
                  f"({flops / t['graph'] / 1e9:.1f} TFLOP/s); library eager "
                  f"{t['lib_eager']:.4f}, graph {t['lib_graph']:.4f}; bound {b:.4f} ({by})"
                  + ("" if shape in counted else " [not in the request]"), flush=True)
            if shape in counted:
                for key in tot:
                    tot[key] += t[key]
        print(f"{fmt}: sum over the request's distinct shapes (one launch each): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
