#!/usr/bin/env python3
"""Where the time of the q4_k / q6_k kernels (csrc/qmm_kquant.cu) goes: the
kernel as it is, beside copies of it with parts of the work taken out.

    python3 tools/ablate_qmm_kquant.py

Builds three shared libraries from csrc/qmm_kquant.cu into
build/kernels/ablate/ (one nvcc each, in parallel):
  as-is     the source unchanged
  no-dequant  the consumers' dequant replaced by constant A fragments
  no-dequant-no-x  that, and the x tile's TMA copies left out
and times each at the 60 s request's M = 768 decoder products and the 120 s
bucket's gate-up (CUDA-graph replay, warm L2), with the rate and, for the
unchanged kernel, the share of its bf16 outputs equal to the plain version's.
The copies compute wrong products on purpose: they show how much of the time
the dequant and the x stream take.  The card's name and power limit come
first.  Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "acestep_tpu_torch", "csrc", "qmm_kquant.cu")
OUT = os.path.join(ROOT, "build", "kernels", "ablate")
SHAPES = [(768, 2048, 2048), (768, 2048, 4096), (768, 2048, 12288), (768, 6144, 2048),
          (1536, 2048, 12288)]
# (anchor in the source, what replaces it)
NO_DEQUANT = ("  const int r0 = 16 * jj + 2 * q;\n",
              "  for (int i = 0; i < 8; ++i) a[i] = 0x3F803F80u + jj;\n  return;\n"
              "  const int r0 = 16 * jj + 2 * q;\n")
NO_X = (("      if (pt == 0) {\n        // x: two atoms", "      if (false) {\n        // x: two atoms"),
        ("mbar_init(&full[i], PRODUCERS + 1);", "mbar_init(&full[i], PRODUCERS);"))
VARIANTS = {"as-is": (), "no-dequant": (NO_DEQUANT,), "no-dequant-no-x": (NO_DEQUANT,) + NO_X}


def build():
    from acestep_tpu_torch.ops.cuda import _build

    os.makedirs(OUT, exist_ok=True)
    src = open(SOURCE).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for anchor, new in edits:
            if text.count(anchor) != 1:
                raise RuntimeError(f"ablate: anchor not found once in {SOURCE}: {anchor!r}")
            text = text.replace(anchor, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"ablate: nvcc failed for {name}:\n{text}")
        handle = ctypes.CDLL(lib)
        for fmt, fields in (("q4_k", 9), ("q6_k", 8)):
            fn = getattr(handle, f"acestep_qmm_{fmt}")
            fn.argtypes = [ctypes.c_void_p] * fields + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = handle
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_qmm_kquant: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from acestep_tpu_torch.ops.cuda import qmm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    libs = build()
    for fmt in ("q4_k", "q6_k"):
        for i, (m, k, n) in enumerate(SHAPES):
            case = cs.QmmCase(fmt, m, k, n, 300 + i)
            ref = qmm.qmm_plain(case.x, case.qt).float()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            bm, splits = qmm.kquant_plan(m, k, n)
            ptrs = qmm.field_ptrs(case.qt, case.x.device)
            parts = []
            for name, handle in libs.items():
                fn = getattr(handle, f"acestep_qmm_{fmt}")

                def call():
                    return fn(case.x.data_ptr(), *ptrs, None, out.data_ptr(), None, m, n, k, 1,
                              bm, splits, torch.cuda.current_stream().cuda_stream)

                if call() != 0 or splits != 1:
                    raise RuntimeError(f"ablate: {name} {fmt} ({m}, {k}, {n}) did not launch")
                torch.cuda.synchronize()
                ms = cs.graph_ms(call)
                note = ""
                if name == "as-is":
                    equal = float((out.float() == ref).float().mean())
                    note = f", bf16 outputs equal to the plain version's {equal:.5f}"
                parts.append(f"{name} {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s{note})")
            print(f"{fmt} M={m} K={k} N={n}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
