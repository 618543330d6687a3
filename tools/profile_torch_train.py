#!/usr/bin/env python3
"""Where the time of one training step goes in the PyTorch/CUDA port.

    python3 tools/profile_torch_train.py [--modes lora lokr full] [--top 12]

Draws the full-width bf16 DiT on the card (per-layer lists, as training takes
it) and chip_smoke.py's phase-train batch (2 x 250 frames, 320 condition
tokens), then per mode: two warm-up steps, one step split into its parts
(the adapter's merge, the loss's forward, the backward, the NaN guard and
global norm, the AdamW update; each ended by a synchronize, host clock), and
one step under torch.profiler (CPU + CUDA activities): device time by kernel
name (top N), the device busy time against the step's wall time (the idle
share) and the number of kernels launched.  Needs one NVIDIA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", nargs="+", default=["lora", "lokr", "full"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from acestep_tpu_torch import weights
    from acestep_tpu_torch.config import DiTConfig
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.training import flow_matching as fm
    from acestep_tpu_torch.training import lokr, lora

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DiTConfig()
    base = chip_smoke.list_tree(RandomInit(torch.device("cuda"), 7, None), cfg)
    batch = chip_smoke.train_batch(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    opt = fm.make_optimizer(lr=1e-4, warmup_steps=1, total_steps=100)
    print(f"card: {torch.cuda.get_device_name(0)}; the 2048 x 24 DiT in bf16, batch 2 x "
          f"{chip_smoke.TRAIN_T} frames, {chip_smoke.TRAIN_LC} condition tokens")

    def sync():
        torch.cuda.synchronize()

    for mode in args.modes:
        loss_base = fm.loss_params(base)
        if mode == "lora":
            tree = lora.init_lora(torch.Generator(device="cuda").manual_seed(0), base, rank=16)
            step = lora.make_lora_train_step(base, cfg, opt, alpha=16.0)

            def merged(t):
                return lora.merge_tree(loss_base, t, lambda w, ll: lora.train_delta(ll, 16.0))
        elif mode == "lokr":
            tree = lokr.init_lokr(torch.Generator(device="cuda").manual_seed(0), base, factor=8)
            step = lokr.make_lokr_train_step(base, cfg, opt, alpha=16.0)

            def merged(t):
                return lokr.apply_lokr(loss_base, t, 16.0)
        else:
            tree, step = base, fm.make_train_step(cfg, opt)

            def merged(t):
                return t
        state = opt.init(tree)
        for _ in range(2):
            tree, state, _ = step(tree, state, batch, *fm.draw(gen, batch["latents"]))
        sync()
        # one step split into its parts
        t_draw = fm.draw(gen, batch["latents"])
        parts = {}
        t0 = time.perf_counter()
        leaves = [x.detach() for x in weights.tree_leaves(tree)]
        live = [x.detach().requires_grad_() for x in leaves]
        m = merged(weights.tree_unflatten(tree, live))
        sync()
        parts["merge"] = time.perf_counter() - t0
        t = time.perf_counter()
        loss = fm.flow_matching_loss(m, cfg, batch, *t_draw)
        sync()
        parts["forward"] = time.perf_counter() - t
        t = time.perf_counter()
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        sync()
        parts["backward"] = time.perf_counter() - t
        t = time.perf_counter()
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        _, norm = torch.stack([finite.float(), opt.global_norm(grads)]).tolist()
        sync()
        parts["guard and norm"] = time.perf_counter() - t
        t = time.perf_counter()
        opt.apply(leaves, grads, state, norm)
        sync()
        parts["AdamW"] = time.perf_counter() - t
        total = time.perf_counter() - t0
        del m, loss, grads, live
        print(f"\n{mode}: one step split (ms, each part ended by a synchronize): "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in parts.items())
              + f"; total {total * 1e3:.1f}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tree, state, _ = step(tree, state, batch, *fm.draw(gen, batch["latents"]))
            sync()
            wall = time.perf_counter() - t
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels
                       if e.self_device_time_total > 0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        launches = sum(r[2] for r in rows)
        print(f"{mode}: step wall {wall * 1e3:.1f} ms under the profiler; device busy "
              f"{busy:.1f} ms ({'not measured' if busy == 0 else f'idle share {1 - busy / (wall * 1e3):.3f}'}); "
              f"{launches} kernels")
        for name, ms, count in rows[:args.top]:
            print(f"  {ms:9.2f} ms  x{count:<6d} {name[:110]}")
        del tree, state
        torch.cuda.empty_cache()
    print(chip_smoke.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
