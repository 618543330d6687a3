#!/usr/bin/env python3
"""chip_smoke.py's phase planners alone: the 1.7B and 4B LM planners on the card.

    python3 tools/planners_phase.py

Run from the repository's root.  Builds the kernels, draws the full-width q4_k
engine of phase full (its configs[2] song runs with the 1.7B), measures
check_mega's bound at the 0.6B's 28 layers (1.5x this run's card-vs-CPU drift
of row 11's plain version), then runs ``chip_smoke.planners_phase``: the 1.7B
through the converter and ``build_lm``, the song, an int8_act codes phase; the
4B through ``save_params`` and ``build_lm``, codes phases with decode_attn
auto / pallas / fused and with int8_act at 16 candidates; each planner's first
decode steps on every kernel path against the plain path; every launched
shape of rows 1, 6, 9 and 10 against its plain version; the rows' times at the
4B's shapes.  Prints the card's name and power limit first and the launches by
kernel last.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    import numpy as np

    import chip_smoke as cs
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.serving import lm as lm_serving

    setup = cs.phase_alone("planners_phase")
    if setup is None:
        return 2
    _, recheck = setup
    seen = set()

    def once(fn, key, *args):
        if key not in seen:
            seen.add(key)
            fn(*args)

    try:
        layers = lm_serving.fuse_serving_params(
            qwen.init_params(QWEN3_0_6B, device="cuda", seed=11, quant="q8_0"))["layers"]
        rel_max = cs.check_mega(layers, QWEN3_0_6B)[1][0]
        del layers
        cs.free_engine()
        engine = pipeline.build_random_engine(device="cuda", quant="q4_k", seed=0)
        style = np.random.default_rng(0).integers(0, 150000, (1, 64))
        lyric = np.random.default_rng(1).integers(0, 150000, (1, 256))
        launched = cs.planners_phase(
            engine, style, lyric, recheck,
            lambda shape: once(cs.check_int8, ("int8", shape), shape, 99),
            lambda shape, fused: once(cs.check_attn_at, (fused, shape), shape, fused),
            rel_max)
    except cs.Failure as exc:
        cs.log(f"FAILED in phase planners: {exc}")
        return 1
    print(json.dumps({k: v for k, v in launched.items() if v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
