#!/usr/bin/env python3
"""chip_smoke.py's phase quality alone: the quantization-quality tools on the card.

    python3 tools/quality_phase.py

Run from the repository's root.  Builds the kernels, then runs
``chip_smoke.quality_phase``: (a) eval_quant_pipeline at full width (10 s,
bf16 and the four formats from one bf16 tree), (b) train_quality_eval on the
reduced schedule with rows 7-8's backward held to the plain version's
autograd at the half-scale encoder's shapes, (c) the half-scale VAE steps on
the card against the CPU, (d) ablate_quant_noise's parts A-C.  Every
dequant-matmul, res-unit and trio shape the phase launches is held to its
plain version as chip_smoke.py's phase check holds it (here every shape, as
no earlier phase checked any).  Outputs go to build/quality/.  Prints the
card's name and power limit first and the launches by kernel last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    import torch

    import chip_smoke as cs
    from acestep_tpu_torch.ops.cuda import _build, qmm

    if not torch.cuda.is_available():
        print("quality_phase: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.lib()
    cs.log(f"kernels built in {time.perf_counter() - t:.1f} s")
    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    unit, trio = cs.vru_names()
    checked = {name: set() for name in list(names.values()) + [unit, trio]}

    def recheck(shapes, seed):
        for fmt, name in names.items():
            for shape in set(shapes[name]) - checked[name]:
                cs.check_qmm(fmt, shape, seed)
                checked[name].add(shape)
        for name, check in ((unit, cs.check_unit), (trio, cs.check_trio)):
            for shape in set(shapes[name]) - checked[name]:
                check(shape, seed)
                checked[name].add(shape)

    try:
        launched = cs.quality_phase(names, unit, trio, smi, recheck)
    except cs.Failure as exc:
        cs.log(f"FAILED in phase quality: {exc}")
        return 1
    print(json.dumps({k: v for k, v in launched.items() if v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
