#!/usr/bin/env python3
"""Per-shape times of the port's dequant-matmul kernels at a request's shapes,
on the card.

    python3 tools/time_qmm_shapes.py [--formats q8_0 q4_0 q4_k q6_k]
                                     [--frames 1536 | --duration 60]
                                     [--extra 1536x2048x12288 ...] [--host]

Run it from the root of a checkout: it times that checkout's
``acestep_tpu_torch`` (so one call can time two trees, for example a parent
commit unpacked beside the working tree, on one card), with the shapes, inputs
and timers of the ``chip_smoke.py`` beside this tool.
For every (M, K, N) that a batch-1 request with ``--frames`` latent frames
sends to each format's kernel (one launch each), or, with ``--duration``, that
one full-width request of that many seconds launched on a random engine of the
format (each shape weighted by its launches), it prints the kernel's time two
ways, both with CUDA events and warm L2: eager (back-to-back wrapper calls, so
a shape whose device time is below the wrapper's host cost shows the host
cost) and as the replay of a CUDA graph of the same calls (device time only),
beside ``torch.matmul`` on the dequantized bf16 weight timed the same two ways,
the bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s) and the rate;
then the sums.  With ``--host``, also the host's microseconds a call (the
wrapper, its ``torch.empty``, its C entry alone) and the thread-block clusters
the card holds at once.  The card's name and power limit come first.  Needs
one NVIDIA GPU; imports no JAX.
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


def request_counts(fmt: str, duration: float) -> dict:
    """{(M, K, N): launches} of the format's kernel in one full-width request
    of ``duration`` seconds (64 style and 256 lyric tokens, as chip_smoke.py's)
    on a random engine quantized to ``fmt``."""
    import numpy as np
    import torch
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.ops.cuda import qmm

    engine = pipeline.build_random_engine(device="cuda", quant=fmt, seed=0)
    rng = np.random.default_rng(0)
    req = pipeline.GenerationRequest(duration_s=duration,
                                     style_token_ids=rng.integers(0, 150000, (1, 64)),
                                     lyric_token_ids=rng.integers(0, 150000, (1, 256)),
                                     seeds=[1])
    kern = qmm.KERNELS[fmt]
    kern.reset()
    engine.generate(req)
    counts = dict(kern.shapes)
    del engine
    torch.cuda.empty_cache()
    return counts


def host_us(qmm, case, calls: int = 200) -> dict:
    """Host microseconds a call (wall clock over ``calls`` back-to-back calls,
    no synchronisation inside): the wrapper, its ``torch.empty`` of the
    output alone, and, where the checkout has ``wgmma_plan``, its C entry
    alone with the arguments made once."""
    import time

    import torch

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    m, k = case.x.shape
    n = case.qt.shape[1]
    out = {"wrapper": per_call(lambda: qmm._launch(case.x, case.qt, None, torch.bfloat16)),
           "torch.empty": per_call(lambda: torch.empty((m, n), dtype=torch.bfloat16,
                                                       device=case.x.device))}
    if hasattr(qmm, "wgmma_plan"):
        from acestep_tpu_torch.ops.cuda import _build

        kern = qmm.KERNELS[case.qt.fmt]
        y = torch.empty((m, n), dtype=torch.bfloat16, device=case.x.device)
        bm, splits = qmm.wgmma_plan(case.qt.fmt, m, k, n, qmm.device_clusters)
        slots = kern.slots.pack(kern.fmt_id, case.x.data_ptr(),
                                *qmm.field_ptrs(case.qt, case.x.device), 0, y.data_ptr(),
                                m, n, k, 1, bm, splits, _build.stream_ptr(case.x))
        out["C entry"] = per_call(lambda: _build.lib().acestep_qmm(slots))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", nargs="+", default=["q8_0", "q4_0", "q4_k", "q6_k"])
    ap.add_argument("--frames", type=int, default=1536)
    ap.add_argument("--duration", type=float, default=None,
                    help="weight the shapes of one request of this many seconds")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="more shapes MxKxN, timed for every format")
    ap.add_argument("--host", action="store_true",
                    help="also the host's cost of a call, and the clusters the card holds")
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
    print(f"card: {smi.stdout.strip()}; checkout {os.getcwd()} ({qmm.__file__})", flush=True)
    if args.host and hasattr(qmm, "device_clusters"):
        for fmt in args.formats:
            print(f"{fmt}: clusters the card holds at once, by (bm, splits): " + ", ".join(
                f"({bm}, {s}) {qmm.device_clusters(fmt, bm, s)}"
                for bm in (16, 64, 128) for s in range(2, qmm.MAX_SPLITS + 1)), flush=True)
    shapes = cs.main_path_shapes(DiTConfig(), QwenConfig(), frames=args.frames)
    extra = [tuple(int(v) for v in e.split("x")) for e in args.extra]
    for fmt in args.formats:
        tot = {"eager": 0.0, "graph": 0.0, "lib_eager": 0.0, "lib_graph": 0.0}
        if args.duration is None:
            counts = {s: 1 for s in cs.shapes_by_kernel(fmt, shapes).get(fmt, [])}
            what = f"sum over the {args.frames}-frame request's distinct shapes (one launch each)"
        else:
            counts = request_counts(fmt, args.duration)
            what = (f"per {args.duration:g} s request ({sum(counts.values())} launches, "
                    f"each shape weighted by its launches)")
        for i, shape in enumerate(sorted(counts) + [s for s in extra if s not in counts]):
            case = cs.QmmCase(fmt, *shape, 200 + i)

            def kern():
                return qmm._launch(case.x, case.qt, None, torch.bfloat16)

            def lib():
                return torch.matmul(case.x, case.wd)

            t = {"eager": cs.cuda_ms(kern, iters=20), "graph": cs.graph_ms(kern),
                 "lib_eager": cs.cuda_ms(lib, iters=20), "lib_graph": cs.graph_ms(lib)}
            b, by = case.bound()
            flops = 2.0 * shape[0] * shape[1] * shape[2]
            cnt = counts.get(shape, 0)
            plan = f" (bm, splits) {qmm.wgmma_plan(fmt, *shape, qmm.device_clusters)}" \
                if hasattr(qmm, "wgmma_plan") else ""
            print(f"{fmt} M={shape[0]} K={shape[1]} N={shape[2]}{plan}: kernel eager "
                  f"{t['eager']:.4f} ms, graph {t['graph']:.4f} ms "
                  f"({flops / t['graph'] / 1e9:.1f} TFLOP/s); library eager "
                  f"{t['lib_eager']:.4f}, graph {t['lib_graph']:.4f}; bound {b:.4f} ({by})"
                  + (f"; x{cnt}" if cnt else " [not in the request]"), flush=True)
            for key in tot:
                tot[key] += cnt * t[key]
            if args.host:
                print(f"  host us a call: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in host_us(qmm, case).items()), flush=True)
        print(f"{fmt}: {what}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
