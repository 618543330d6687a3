#!/usr/bin/env python3
"""chip_smoke.py's phase tp alone: serving from a (dp, tp) group of processes.

    python3 tools/tp_phase.py                # world 1 over NCCL, worlds 2 and 4 over gloo on cuda:0
    python3 tools/tp_phase.py --cards        # only NCCL over every card of the machine, a card a rank
    python3 tools/tp_phase.py --cards --cli  # and the CLI under torchrun over every card

Run from the repository's root.  The single-process references that the
script's earlier phases serve are served here first (configs[0]'s 10 s q8_0
request and its batch of two, configs[1]'s 60 s request at q4_k, phase
lm_engine's 0.6B q8_0 planner), then ``chip_smoke.TpPhase`` runs the worlds:
each world's ranks are children of chip_smoke.py, every rank's outputs are
held equal, latents to the one process at the Q8_0 gate, the waveform to the
one process's decode of those latents and, within a margin, to the one
process's waveform as far as a noise witness says it can come, the planner's
greedy codes to the one process's.  Every dequant-matmul, res-unit / trio and
decode-attention shape a rank launched that the script's phase check did not
is held to its plain version here too.  The planner's tokens are held against
``--drift`` (the x drift chip_smoke.py's check_mega measures at 28 layers,
2.41e-2 on an H100 80GB HBM3 at 700 W), since check_mega itself does not run
here.  ``--cli`` then runs ``acestep_tpu_torch.cli --pipeline-style-lyric``
(10 s, seed 0, random q8_0 weights) under ``torchrun --standalone`` over every
card and in one process, and compares rank 0's WAV with the one process's.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", action="store_true",
                    help="only the NCCL world over every card of the machine")
    ap.add_argument("--drift", type=float, default=2.41e-2)
    ap.add_argument("--cli", action="store_true",
                    help="also the CLI under torchrun over every card against one process")
    args = ap.parse_args()
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from acestep_tpu_torch import pipeline
    from acestep_tpu_torch.config import QWEN3_0_6B
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.ops.cuda import _build, decode_attn, qmm
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru
    from acestep_tpu_torch.serving import lm as lm_serving

    if not torch.cuda.is_available():
        print("tp_phase: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.lib()
    cs.log(f"kernels built in {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    style, lyric = rng.integers(0, 150000, (1, 64)), rng.integers(0, 150000, (1, 256))
    req = pipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                     lyric_token_ids=lyric, seeds=[1])
    engine = pipeline.build_random_engine(device="cuda", quant="q8_0", seed=0)
    results = {"10s": [engine.generate(req)]}
    results["b2"] = [engine.generate(pipeline.GenerationRequest(
        duration_s=10.0, batch_size=2, style_token_ids=np.repeat(style, 2, 0),
        lyric_token_ids=np.repeat(lyric, 2, 0), seeds=[1, 2]))]
    del engine
    cs.free_engine()
    results["60s q4_k"] = [None]
    if not args.cards:
        engine = pipeline.build_random_engine(device="cuda", quant="q4_k", seed=0)
        results["60s q4_k"] = [engine.generate(
            pipeline.GenerationRequest(duration_s=60.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1]))]
        del engine
        cs.free_engine()
    lm_params = lm_serving.fuse_serving_params(lm_serving.ensure_quantized_head(
        qwen.init_params(QWEN3_0_6B, device="cuda", seed=7, quant="q8_0")))

    names = {fmt: k.name for fmt, k in qmm.KERNELS.items()}
    checked = set()

    def recheck(shapes, seed):
        for fmt, name in names.items():
            for shape in shapes.get(name, {}):
                if (name, shape) not in checked:
                    cs.check_qmm(fmt, shape, seed)
                    checked.add((name, shape))
        for name, check in ((vru.UNIT.name, cs.check_unit), (vru.TRIO.name, cs.check_trio)):
            for shape in shapes.get(name, {}):
                if (name, shape) not in checked:
                    check(shape, seed)
                    checked.add((name, shape))

    def check_attn(shape, fused):
        name = decode_attn.FUSED.name if fused else decode_attn.ATTN.name
        if (name, shape) in checked:
            return
        b, hq, hkv, t_max = shape
        c = cs.attn_case(b, [max(1, (t_max - 1) * (i + 1) // b) for i in range(b)], 88,
                         t_max=t_max, hq=hq, hkv=hkv)
        for li in (0, 27):
            if fused:
                got = decode_attn.decode_attention_fused_stacked(*cs.fused_args(c, li))
                ref = decode_attn.decode_attention_fused_plain(*cs.fused_args(c, li))
            else:
                got = decode_attn.decode_attention_int8_stacked(*cs.attn_args(c, li))
                ref = decode_attn.decode_attention_plain(*cs.attn_args(c, li))
            cs.check_attn_pair(f"{name} {shape} layer {li}", got, ref, fused)
        checked.add((name, shape))

    try:
        tp = cs.TpPhase(results, lm_params, args.drift, recheck, check_attn)
        if args.cards:
            tp.card_world(torch.cuda.device_count())
        else:
            tp.run()
    except cs.Failure as exc:
        cs.log(f"FAILED: {exc}")
        return 1
    cs.log("launches (every rank, summed): "
           + ", ".join(f"{k} {v}" for k, v in tp.launched.items() if v))
    return cli_worlds(torch.cuda.device_count()) if args.cli else 0


def cli_worlds(n: int) -> int:
    """The CLI's 10 s request under torchrun over ``n`` cards and in one
    process: every rank must exit 0 and rank 0's WAV must be finite, of the
    one process's length and not silent; its cosine and SNR against the one
    process's WAV are printed (phase tp holds the meshed engine itself)."""
    import numpy as np

    import chip_smoke as cs
    from acestep_tpu_torch import eval_metrics
    from acestep_tpu_torch.utils.audio import read_wav

    out = os.path.join(ROOT, "build", "tp_cli")
    os.makedirs(out, exist_ok=True)
    base = ["-m", "acestep_tpu_torch.cli", "--pipeline-style-lyric", "--audio-seconds", "10"]
    runs = {"1 process": [sys.executable] + base,
            f"torchrun, {n} cards": [sys.executable, "-m", "torch.distributed.run",
                                     "--standalone", f"--nproc-per-node={n}"] + base}
    wavs = {}
    for i, (tag, cmd) in enumerate(runs.items()):
        wavs[tag] = os.path.join(out, f"run{i}.wav")
        t = time.perf_counter()
        p = subprocess.run(cmd + ["--out", wavs[tag]], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        cs.log(f"cli ({tag}): exit {p.returncode} in {time.perf_counter() - t:.1f} s; "
               f"stdout {p.stdout.strip()[-300:]}")
        if p.returncode != 0:
            cs.log(f"cli ({tag}) stderr (end):\n{p.stderr[-3000:]}")
            return 1
    (ref, _), (got, _) = (read_wav(w) for w in wavs.values())
    ok = (got.shape == ref.shape and bool(np.isfinite(got).all())
          and float(np.abs(got).max()) > 0)
    cs.log(f"cli: torchrun over {n} cards against one process: shapes {got.shape} / "
           f"{ref.shape}, cosine {eval_metrics.cosine(ref.ravel(), got.ravel()):.6f}, SNR "
           f"{eval_metrics.snr_db(ref.ravel(), got.ravel()):.2f} dB; "
           + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
