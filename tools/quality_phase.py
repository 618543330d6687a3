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
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    import chip_smoke as cs
    from acestep_tpu_torch.ops.cuda import qmm

    setup = cs.phase_alone("quality_phase")
    if setup is None:
        return 2
    smi, recheck = setup
    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    unit, trio = cs.vru_names()
    try:
        launched = cs.quality_phase(names, unit, trio, smi, recheck)
    except cs.Failure as exc:
        cs.log(f"FAILED in phase quality: {exc}")
        return 1
    print(json.dumps({k: v for k, v in launched.items() if v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
