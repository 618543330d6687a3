#!/usr/bin/env python3
"""Times of the DiT Euler-step megakernel (kernel row 12) at the full-width
DiT's shapes, on the card.

    python3 tools/time_dit_mega.py [--grids 132 264]

Run it from the root of a checkout: it times that checkout's
``acestep_tpu_torch`` with the helpers of the ``chip_smoke.py`` beside this
tool, so one call can time two trees (a parent commit unpacked beside the
working tree) on one card.  On one random full-width q8_0 DiT (24 layers,
drawn on the card from a seed) it prints
  * row 12 ms a launch at T = 128 (10.24 s) and T = 256 (20.48 s), Lc = 320,
    beside its bound (chip_smoke.dit_bound): CUDA events over back-to-back
    launches, warm L2, at the launch's own grid;
  * the stage split of one launch at each T (``dit_mega.stage_times``: the
    stamps each version records, summed over the layers);
  * row 12 at T = 128 on each grid of --grids (a grid the kernel refuses is
    named so);
  * the whole DiT step (``dit.forward``, CUDA events) at T = 128 with
    ``dit_mega`` and ``int8_act`` on, and on the layer path.
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
T_ROWS = (128, 256)
LC = 320


def _smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grids", type=int, nargs="*", default=[132, 264])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_dit_mega: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke_helpers()
    from acestep_tpu_torch.config import DiTConfig
    from acestep_tpu_torch.models import dit
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.ops.cuda import dit_mega
    from acestep_tpu_torch.ops.qlinear import precast_quant_scales

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; checkout {os.getcwd()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DiTConfig()
    n_l = cfg.num_hidden_layers
    dev = torch.device("cuda")
    params = precast_quant_scales(dit.fuse_params(dit.stack_params(
        RandomInit(dev, 11, "q8_0").dit(cfg))))
    layers = params["layers"]
    init = RandomInit(dev, 12, "q8_0")
    for t in T_ROWS:
        margs = smoke.dit_mega_inputs(init, cfg, n_l, t, LC)
        ms = smoke.cuda_ms(lambda: dit_mega.dit_layers_mega(layers, cfg, *margs), iters=20)
        b, by = smoke.dit_bound(cfg, t, LC)
        stamps = torch.zeros(2 + len(dit_mega.STAGES) * n_l, dtype=torch.int64, device=dev)
        dit_mega.dit_layers_mega(layers, cfg, *margs, stamps=stamps)
        split = dit_mega.stage_times(stamps, n_l)
        print(f"row 12 T={t} Lc={LC} {n_l} layers: {ms:.4f} ms a launch, bound {b:.4f} ({by})",
              flush=True)
        print(f"row 12 T={t} stage split (ms a launch, summed over the layers): "
              + json.dumps({k: round(v, 4) for k, v in split.items()})
              + f"; total {sum(split.values()):.4f}", flush=True)
    margs = smoke.dit_mega_inputs(init, cfg, n_l, T_ROWS[0], LC)
    for grid in args.grids:
        try:
            ms = smoke.cuda_ms(lambda: dit_mega.dit_layers_mega(layers, cfg, *margs, grid=grid),
                               iters=20)
            print(f"row 12 T={T_ROWS[0]} grid {grid}: {ms:.4f} ms a launch", flush=True)
        except (RuntimeError, ValueError) as exc:
            torch.cuda.synchronize()
            print(f"row 12 T={T_ROWS[0]} grid {grid}: not launched ({exc})", flush=True)
    t = T_ROWS[0]
    hs = init.normal((1, 2 * t, cfg.audio_acoustic_hidden_dim), 1.0).bfloat16()
    ctx = init.normal((1, 2 * t, cfg.context_dim), 1.0).bfloat16()
    enc = dit.compute_condition(params, cfg, init.normal((1, LC, cfg.hidden_size), 1.0).bfloat16())
    kv = dit.compute_all_cross_kv(params, cfg, enc)
    kv_st = dit.stack_cross_kv(kv)
    tt = torch.full((1,), 0.5, device=dev)
    encm = torch.ones((1, LC), dtype=torch.int32, device=dev)
    for mega in (True, False):
        n0 = dit_mega.MEGA.launches
        ms = smoke.cuda_ms(lambda: dit.forward(params, cfg, hs, tt, tt, ctx, kv,
                                               encoder_attn_mask=encm, dit_mega=mega,
                                               int8_act=mega, cross_kv_stacked=kv_st), iters=10)
        ran = dit_mega.MEGA.launches > n0
        print(f"DiT step (dit.forward) T={t}, dit_mega={mega}: {ms:.4f} ms "
              f"(megakernel launched: {ran})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
