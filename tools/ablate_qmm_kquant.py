#!/usr/bin/env python3
"""Where the time of the dequant-matmul kernel (csrc/qmm_wgmma.cu) goes: the
kernel as it is, beside copies of it with parts of the work taken out.

    python3 tools/ablate_qmm_kquant.py [--formats q4_k q6_k] [--frames 1536]

Builds three shared libraries from csrc/qmm_wgmma.cu into
build/kernels/ablate/ (one nvcc each, in parallel):
  as-is     the source unchanged
  no-dequant  the consumers' dequant replaced by constant A fragments
  no-dequant-no-x  that, and the x tile's TMA copies left out
and times each, for every format named, at the decoder products of a request
with ``--frames`` latent frames (M = frames / 2 patches: 768 at 60 s, 128 at
10 s; K % 256 != 0 left out for the 4-bit formats) and the 120 s bucket's
gate-up (CUDA-graph replay, warm L2), with the rate and, for the unchanged
kernel, the share of its bf16 outputs equal to the plain version's.  The
copies compute wrong products on purpose: they show how much of the time the
dequant and the x stream take.  The card's name and power limit come first.
Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "acestep_tpu_torch", "csrc", "qmm_wgmma.cu")
OUT = os.path.join(ROOT, "build", "kernels", "ablate")
# the decoder's (K, N): fused qkv, o_proj / cross q / cross o, fused gate-up,
# down, and proj_in (K = 384, q8_0 only)
DECODER = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048), (384, 2048)]
GATE_UP_120S = (1536, 2048, 12288)
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
        handle.acestep_qmm.argtypes = _build.SIGNATURES["acestep_qmm"]
        handle.acestep_qmm.restype = ctypes.c_int
        libs[name] = handle
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--formats", nargs="+", default=["q4_k", "q6_k"])
    ap.add_argument("--frames", type=int, default=1536)
    args = ap.parse_args()

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
    for fmt in args.formats:
        shapes = [(args.frames // 2, k, n) for k, n in DECODER
                  if k % qmm.K_ALIGN[fmt] == 0] + [GATE_UP_120S]
        for i, (m, k, n) in enumerate(shapes):
            case = cs.QmmCase(fmt, m, k, n, 300 + i)
            ref = qmm.qmm_plain(case.x, case.qt).float()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            bm, splits = qmm.wgmma_plan(fmt, m, k, n, qmm.device_clusters)
            kern = qmm.KERNELS[fmt]
            head = (kern.fmt_id, case.x.data_ptr(), *qmm.field_ptrs(case.qt, case.x.device), 0,
                    out.data_ptr(), m, n, k, 1, bm, splits)
            parts = []
            for name, handle in libs.items():
                def call(fn=handle.acestep_qmm):     # on the current stream (graph capture)
                    return fn(kern.slots.pack(*head, torch.cuda.current_stream().cuda_stream))

                if call() != 0:
                    raise RuntimeError(f"ablate: {name} {fmt} ({m}, {k}, {n}) did not launch")
                torch.cuda.synchronize()
                ms = cs.graph_ms(call)
                note = ""
                if name == "as-is":
                    equal = float((out.float() == ref).float().mean())
                    note = f", bf16 outputs equal to the plain version's {equal:.5f}"
                parts.append(f"{name} {ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s{note})")
            print(f"{fmt} M={m} K={k} N={n} (bm {bm}, {splits} splits): " + "; ".join(parts),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
