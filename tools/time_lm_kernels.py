#!/usr/bin/env python3
"""Times of the LM planner's decode-shaped q8_0 kernels at configs[2]'s
shapes, on the card.

    python3 tools/time_lm_kernels.py [--batch 1] [--plans]

Run it from the root of a checkout: it times that checkout's
``acestep_tpu_torch`` with the helpers of the ``chip_smoke.py`` beside this
tool, so one call can time two trees (a parent commit unpacked beside the
working tree) on one card.  It prints
  * kernel row 6 (int8 activations, ops/cuda/qmm_int8.py) at request B's
    shapes, M = --batch: the four layer linears of Qwen3-0.6B (qkv, o_proj,
    gate-up, down) and the codes head, each as the kernel's eager time a
    launch (back-to-back wrapper calls, CUDA events, warm L2) and its device
    time alone (the replay of a CUDA graph of the same calls), beside
    ``torch.matmul`` on the dequantized bf16 weight timed the same two ways and
    the bound (bytes over 3.35 TB/s); then the sums per request B on the layer
    scan (each layer shape x 28 layers x 767 steps, the head x 768) and on the
    default path (the head x 768);
  * kernel row 11 (the decode megakernel) a launch at B = --batch and the
    three valid lengths chip_smoke.py times (the codes phase's first, middle
    and last step), CUDA events, with the stage split of one launch
    (block 0's clock at the end of each of its stages, summed over the 28
    layers).
With --plans, also row 6's device time at each of those shapes under every
plan the kernel takes (tile width, K splits), each checked bit for bit against
the plain version, beside the plan ``int8_plan`` picks.
The card's name and power limit come first.  Needs one NVIDIA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
STEPS = 767                    # decode steps of configs[2]'s codes phase
LAYER_SHAPES = ((1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024))
HEAD = (1024, 65536)


def _smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_plans(smoke, m, qmm_int8) -> None:
    """Row 6's device time (CUDA graphs) at each shape under every plan."""
    import struct

    import torch
    from acestep_tpu_torch.ops.cuda import _build

    lib = _build.lib()
    for i, (k, n) in enumerate(LAYER_SHAPES + (HEAD,)):
        case = smoke.QmmCase("q8_0", m, k, n, 800 + i)
        ref = qmm_int8.qmm_int8_act_plain(case.x, case.qt)
        nkb, res = k // 32, []
        for bn in qmm_int8.TILES_N:
            for splits in (1, 2, 4, 8):
                per = -(-nkb // splits)
                if splits > nkb or -(-nkb // per) != splits or bn // splits < 4 or n % bn \
                        or qmm_int8.int8_smem(m, k, bn, splits) > qmm_int8.SMEM_MAX:
                    continue
                out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")

                def launch(bn=bn, splits=splits, out=out):
                    _build.check("acestep_qmm_int8", lib.acestep_qmm_int8(struct.pack(
                        "<11q", case.x.data_ptr(), 0, case.qt.data.data_ptr(),
                        case.qt.scales.data_ptr(), out.data_ptr(), m, n, k, bn, splits,
                        _build.stream_ptr(case.x))))

                launch()
                if not torch.equal(out, ref):
                    raise SystemExit(f"row 6 plan ({bn}, {splits}) at {m}x{k}x{n} differs")
                res.append((smoke.graph_ms(launch) * 1e3, bn, splits, n // bn * splits))
        res.sort()
        print(f"row 6 M={m} K={k} N={n} plans (int8_plan: {qmm_int8.int8_plan(m, k, n)}): "
              + ", ".join(f"({bn}, {sp}) {blocks} blocks {us:.2f} us"
                          for us, bn, sp, blocks in res))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_lm_kernels: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke_helpers()
    from acestep_tpu_torch import lm_pipeline
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.ops.cuda import decode_mega, qmm_int8
    from acestep_tpu_torch.serving import lm as lm_serving

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; checkout {os.getcwd()}")
    m = args.batch
    n_layers = QWEN3_0_6B.num_hidden_layers
    totals = {"layer scan": dict.fromkeys(("ms", "dev", "lib", "lib_dev", "bound"), 0.0),
              "default": dict.fromkeys(("ms", "dev", "lib", "lib_dev", "bound"), 0.0)}
    for i, (k, n) in enumerate(LAYER_SHAPES + (HEAD,)):
        case = smoke.QmmCase("q8_0", m, k, n, 700 + i)

        def kern():
            return qmm_int8._launch(case.x, case.qt)

        def lib():
            return torch.matmul(case.x, case.wd)

        t = {"ms": smoke.cuda_ms(kern, iters=50), "dev": smoke.graph_ms(kern),
             "lib": smoke.cuda_ms(lib, iters=50), "lib_dev": smoke.graph_ms(lib),
             "bound": smoke.int8_bound(m, k, n)[0]}
        print(f"row 6 M={m} K={k} N={n}: kernel {t['ms'] * 1e3:.2f} us eager, "
              f"{t['dev'] * 1e3:.2f} us device; library {t['lib'] * 1e3:.2f} us eager, "
              f"{t['lib_dev'] * 1e3:.2f} us device; bound {t['bound'] * 1e3:.2f} us")
        head = (k, n) == HEAD
        for path, count in (("layer scan", STEPS + 1 if head else STEPS * n_layers),
                            ("default", STEPS + 1 if head else 0)):
            for key in t:
                totals[path][key] += count * t[key]
    if args.plans:
        time_plans(smoke, m, qmm_int8)
    for path, tot in totals.items():
        print(f"row 6 per request B ({path}): kernel {tot['ms']:.2f} ms eager, "
              f"{tot['dev']:.2f} ms device; library {tot['lib']:.2f} ms eager, "
              f"{tot['lib_dev']:.2f} ms device; bound {tot['bound']:.2f} ms")

    layers = lm_serving.fuse_serving_params(
        qwen.init_params(QWEN3_0_6B, device="cuda", seed=7, quant="q8_0"))["layers"]
    l0 = len(smoke.ByteTokenizer().encode(lm_pipeline.build_formatted_prompt_with_cot(
        smoke.LM_CAPTION, smoke.LM_LYRICS, lm_pipeline.metadata_to_cot({"bpm": 100}))))
    stamps = torch.zeros(2 + len(decode_mega.STAGES) * n_layers, dtype=torch.int64,
                         device="cuda")
    per = []
    for n in (l0, l0 + STEPS // 2, l0 + STEPS - 1):
        margs = smoke.mega_case(layers, m, [n] * m, 400)
        ms = smoke.cuda_ms(lambda: decode_mega.decode_layers_mega(layers, QWEN3_0_6B, *margs),
                           iters=50)
        per.append(ms)
        decode_mega.decode_layers_mega(layers, QWEN3_0_6B, *margs, stamps=stamps)
        split = decode_mega.stage_times(stamps, n_layers)
        print(f"row 11 B={m} length {n}: {ms:.4f} ms a launch; bound "
              f"{smoke.mega_bound(QWEN3_0_6B, m, [n] * m)[0]:.4f}; stages (ms, one launch) "
              + json.dumps({key: round(v, 4) for key, v in split.items()}))
    print(f"row 11 per configs[2] request ({STEPS} launches at the mean of the three): "
          f"{sum(per) / len(per) * STEPS:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
