#!/usr/bin/env python3
"""Where the time of the DiT Euler-step megakernel (csrc/dit_mega.cu, kernel
row 12) goes: the kernel as it is, beside copies of it with parts of the work
taken out.

    python3 tools/ablate_dit_mega.py [--t 128]

Builds one shared library per variant from csrc/dit_mega.cu into
build/kernels/ablate_dit/ (one nvcc each, in parallel):
  as-is        the source unchanged
  no-dequant   the GEMMs' dequant replaced by constant A fragments
  no-wgmma     the GEMMs' wgmmas left out (the dequant, copies and hand-overs kept)
  no-attn      the attention units publish at once (no loads, no products)
  no-norm      the norm units publish at once
  weight-ring-5  five weight slots instead of three (the stream runs further ahead)
and times each on one random full-width q8_0 DiT (24 layers, T = --t, Lc =
320; CUDA events over back-to-back launches, warm L2) with its stage split
(block 0's clock at the end of each of its stages, summed over the layers).
The copies compute wrong outputs on purpose: they show how much of the time
each part takes.  The card's name and power limit come first.  Needs one
NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "acestep_tpu_torch", "csrc", "dit_mega.cu")
OUT = os.path.join(ROOT, "build", "kernels", "ablate_dit")
NO_DEQUANT = (("  const int r0 = 16 * jj + 2 * q;\n",
               "  for (int i = 0; i < 8; ++i) a[i] = 0x3F803F80u + jj;\n  return;\n"
               "  const int r0 = 16 * jj + 2 * q;\n"),)
NO_WGMMA = (("            wgmma_rs(acc, a[jj], kmajor_sw128_desc(xaddr + 32 * jj));\n"
             "            wgmma_rs(acc, a[jj] + 4, kmajor_sw128_desc(xaddr + X_SLOT / 2 + 32 * jj));\n",
             "            acc[jj] += __uint_as_float((a[jj][0] ^ a[jj][7]) & 0x3F000000u);\n"),)
NO_ATTN = (("__device__ __noinline__ void attn_unit(const Params& p, uint8_t* xreg, float* red, "
            "int l, int u) {\n",
            "__device__ __noinline__ void attn_unit(const Params& p, uint8_t* xreg, float* red, "
            "int l, int u) {\n"
            "  if (l >= 0) {\n"
            "    publish(p.g[CROSS ? C_CROSS : C_SELF] + u / (p.pairs * p.nqb), true);\n"
            "    return;\n  }\n"),)
NO_NORM = (("__device__ __noinline__ void norm_unit(const Params& p, uint8_t* xreg, int kind, int l, "
            "int u) {\n",
            "__device__ __noinline__ void norm_unit(const Params& p, uint8_t* xreg, int kind, int l, "
            "int u) {\n"
            "  if (l >= 0) {\n    publish(p.g[C_NORM] + kind, true);\n    return;\n  }\n"),)
WR5 = (("constexpr int WR = 3, XR = 4;", "constexpr int WR = 5, XR = 4;"),)
VARIANTS = {"as-is": (), "no-dequant": NO_DEQUANT, "no-wgmma": NO_WGMMA, "no-attn": NO_ATTN,
            "no-norm": NO_NORM, "weight-ring-5": WR5}


def _smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
        so = os.path.join(OUT, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC_DIR, "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"ablate: nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(so)
        for fn in ("acestep_dit_mega", "acestep_dit_mega_smem", "acestep_dit_mega_grid"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=128)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ablate_dit_mega: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke_helpers()
    from acestep_tpu_torch.config import DiTConfig
    from acestep_tpu_torch.ops.cuda import _build, dit_mega

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs = build()
    cfg = DiTConfig()
    n_l = cfg.num_hidden_layers
    layers, margs = smoke.dit_mega_case(cfg, n_l, args.t, 320, 21)
    for name, lib in libs.items():
        _build._lib = lib
        ms = smoke.cuda_ms(lambda: dit_mega.dit_layers_mega(layers, cfg, *margs), iters=10)
        stamps = torch.zeros(2 + len(dit_mega.STAGES) * n_l, dtype=torch.int64, device="cuda")
        dit_mega.dit_layers_mega(layers, cfg, *margs, stamps=stamps)
        split = dit_mega.stage_times(stamps, n_l)
        print(f"{name}: {ms:.4f} ms a launch at T={args.t}; by stage "
              + json.dumps({k: round(v, 4) for k, v in split.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
