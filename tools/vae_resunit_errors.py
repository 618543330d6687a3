#!/usr/bin/env python3
"""How far the VAE res-unit and trio kernels (rows 7 and 8,
``acestep_tpu_torch/ops/cuda/vae_resunit.py``) part from exact arithmetic on
the card, beside their plain f32 versions: the readings behind the 1e-4 bound
of ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.

    python3 tools/vae_resunit_errors.py

For two weight scales (the card tests' 0.05, and ``chip_smoke.py``'s 1/sqrt(7C)
for conv1 and 1/sqrt(C) for conv2) and three trio shapes at C = 128 ((1,
1000), (1, 240000), (2, 77)), it prints for the trio kernel, its single-pass
TF32 build and the unit kernel at C = 128, d = 9: the largest error against
the plain version run in f64 on the card, the same for the plain version in
f32, the kernel's largest error against the f32 plain version over the 1e-4
bound (atol = rtol = 1e-4), and the mean signed error against f64 (a bias
shows truncation); and whether the trio equals, bit for bit, three chained
unit launches (the same tiles, so equal bits rule out a race between the
trio's phases).  The card's name and power limit come first.  Needs one NVIDIA
GPU; imports no JAX.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOL = 1e-4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("vae_resunit_errors: no CUDA device", file=sys.stderr)
        return 2
    from acestep_tpu_torch.ops.cuda import vae_resunit as vru

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def unit_params(seed, w1_scale, w2_scale, c=128):
        g = torch.Generator(device=dev).manual_seed(seed)

        def r(*shape, s=0.3):
            return torch.randn(shape, generator=g, device=dev) * s

        return {"snake1": {"alpha": r(c), "beta": r(c)},
                "conv1": {"w": r(7, c, c, s=w1_scale), "b": r(c, s=0.1)},
                "snake2": {"alpha": r(c), "beta": r(c)},
                "conv2": {"w": r(1, c, c, s=w2_scale), "b": r(c, s=0.1)}}

    def report(name, got, ref64, plain):
        tol = TOL + TOL * plain.abs()
        print(f"  {name}: |kernel - f64| {float((got.double() - ref64).abs().max()):.3e}, "
              f"|plain f32 - f64| {float((plain.double() - ref64).abs().max()):.3e}, "
              f"max |kernel - plain| / bound {float(((got - plain).abs() / tol).max()):.3f}, "
              f"mean (kernel - f64) {float((got.double() - ref64).mean()):.2e}, "
              f"mean (plain - f64) {float((plain.double() - ref64).mean()):.2e}", flush=True)

    scales = (("card tests, 0.05", 0.05, 0.05),
              ("chip_smoke, 1/sqrt(7C), 1/sqrt(C)", 1 / math.sqrt(7 * 128), 1 / math.sqrt(128)))
    for label, s1, s2 in scales:
        for n, length in ((1, 1000), (1, 240000), (2, 77)):
            units = tuple(unit_params(10 + i, s1, s2) for i in range(3))
            ops = vru.trio_operands(units, dev)
            x = torch.randn((n, length, 128), device=dev) * 0.5
            got = vru.launch_trio(x, ops)
            chain = x
            for u, d in zip(units, vru.TRIO_D):
                chain = vru.launch_unit(chain, vru.unit_operands(u, dev), d)
            plain = vru.res_trio_plain(x, *ops.plain)
            ref64 = vru.res_trio_plain(x.double(), *(t.double() for t in ops.plain))
            print(f"[{label}] N={n} L={length}: trio equals three chained unit launches: "
                  f"{torch.equal(got, chain)}", flush=True)
            report("trio", got, ref64, plain)
            report("trio, single-pass TF32", vru.launch_trio_tf32(x, ops), ref64, plain)
            u = vru.unit_operands(units[2], dev)
            report("unit d=9", vru.launch_unit(x, u, 9), vru.res_unit_plain(
                x.double(), *(t.double() for t in u.plain), 9), vru.res_unit_plain(x, *u.plain, 9))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
