#!/usr/bin/env python3
"""Where the time of one request goes in the PyTorch/CUDA port.

    python3 tools/profile_torch_request.py [--duration 10] [--quant q8_0] [--top 15]

Builds the full-width random engine at ``--quant`` on the card, answers the
bench request (64 style + 256 lyric tokens, one seed; configs[0] is 10 s at
q8_0, configs[1] 60 s at q4_0) once as a warm-up, then once under
torch.profiler (CPU + CUDA activities).  Prints the device time by kernel name
(top N), the device busy time against the request's wall time (the idle
share), and the request's time_costs.  Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--quant", default="q8_0", choices=("q8_0", "q4_0", "q4_k", "q6_k"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_request: no CUDA device", file=sys.stderr)
        return 2
    from acestep_tpu_torch import pipeline

    engine = pipeline.build_random_engine(device="cuda", quant=args.quant, seed=0)
    rng = np.random.default_rng(0)
    req = pipeline.GenerationRequest(
        duration_s=args.duration, style_token_ids=rng.integers(0, 150000, (1, 64)),
        lyric_token_ids=rng.integers(0, 150000, (1, 256)), seeds=[1])
    engine.generate(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.generate(req)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # kernel events only (a CPU op's device time repeats its kernels')
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"card: {torch.cuda.get_device_name(0)}; {args.duration:g} s at {args.quant}")
    print(f"request wall {wall_s * 1e3:.1f} ms under the profiler; device busy "
          f"{busy_ms:.1f} ms ({'not measured' if busy_ms == 0 else f'idle share {1 - busy_ms / (wall_s * 1e3):.3f}'})")
    for name, ms, count in rows[:args.top]:
        print(f"  {ms:10.3f} ms  {count:6d} x  {name[:100]}")
    print("time_costs " + json.dumps({k: round(v, 6) for k, v in res.time_costs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
