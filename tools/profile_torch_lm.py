#!/usr/bin/env python3
"""Where the time of the LM planner's codes phase goes in the PyTorch/CUDA port.

    python3 tools/profile_torch_lm.py [--top 15]

Builds the full-width random 0.6B q8_0 planner (fused weights, quantized head,
int8 KV) on the card.  Prints
  * the megakernel's time per launch by stage (block 0's clock at the end of
    each of its stages in one launch, waits included, summed over the 28
    layers) at B = 1, 4, 8 and three cache lengths, beside its CUDA-event time
    per launch;
  * for configs[2]'s LM request (120 s -> 600 codes, bpm 100, no CoT, batch 1,
    the byte tokenizer of chip_smoke.py), answered once as a warm-up, once
    under torch.profiler and once more without it: the device time by kernel
    (top N), the profiled request's device busy time against its own wall time
    (the idle share, the profiler's host cost included) and against the wall
    time of the request without the profiler (an estimate of the idle share
    built from those two requests), and the time_costs of both.
Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_lm: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from acestep_tpu_torch import lm_pipeline
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.ops.cuda import decode_mega

    cfg = QWEN3_0_6B
    pipe = lm_pipeline.LMPipeline(qwen.init_params(cfg, device="cuda", seed=7, quant="q8_0"),
                                  cfg, smoke.ByteTokenizer(), device="cuda")
    layers = pipe.params["layers"]
    print(f"card: {torch.cuda.get_device_name(0)}; 0.6B q8_0 planner, int8 KV, T {smoke.LM_T}")
    stamps = torch.zeros(2 + len(decode_mega.STAGES) * cfg.num_hidden_layers,
                         dtype=torch.int64, device="cuda")
    for b in (1, 4, 8):
        for n in (300, 700, 1060):
            mega_args = smoke.mega_case(layers, b, [n] * b, 5)
            ms = smoke.cuda_ms(lambda: decode_mega.decode_layers_mega(layers, cfg, *mega_args),
                               iters=20)
            decode_mega.decode_layers_mega(layers, cfg, *mega_args, stamps=stamps)
            stages = decode_mega.stage_times(stamps, cfg.num_hidden_layers)
            print(f"decode_mega B={b} length {n}: {ms:.4f} ms a launch (CUDA events); stages "
                  "(ms, 28 layers, one launch) "
                  + json.dumps({k: round(v, 4) for k, v in stages.items()}))

    kw = dict(thinking=False, user_metadata={"bpm": 100}, temperature=0.85, top_p=0.95,
              seed=0)
    pipe.generate_with_stop_condition(smoke.LM_CAPTION, smoke.LM_LYRICS, smoke.LM_DURATION_S, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipe.generate_with_stop_condition(smoke.LM_CAPTION, smoke.LM_LYRICS,
                                                smoke.LM_DURATION_S, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # kernel events only (a CPU op's device time repeats its kernels')
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    t0 = time.perf_counter()
    res2 = pipe.generate_with_stop_condition(smoke.LM_CAPTION, smoke.LM_LYRICS,
                                             smoke.LM_DURATION_S, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if busy_ms == 0:
        idle = "device time not measured"
    else:
        idle = (f"idle share {1 - busy_ms / (wall_s * 1e3):.3f} of the profiled request; "
                f"estimate from two requests: {1 - busy_ms / (plain_s * 1e3):.3f} of the "
                f"request without the profiler")
    print(f"configs[2] LM request: wall {wall_s * 1e3:.1f} ms under the profiler, "
          f"{plain_s * 1e3:.1f} ms without; device busy {busy_ms:.1f} ms ({idle}); "
          f"{len(res.code_indices)} codes")
    for name, ms, count in rows[:args.top]:
        print(f"  {ms:10.3f} ms  {count:6d} x  {name[:100]}")
    for label, r in (("profiled", res), ("without the profiler", res2)):
        print(f"time_costs ({label}) "
              + json.dumps({k: round(v, 6) for k, v in r.time_costs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
