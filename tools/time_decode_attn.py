#!/usr/bin/env python3
"""Times of the decode-attention kernels (rows 9 and 10,
``acestep_tpu_torch/ops/cuda/decode_attn.py``) in each of their designs, on
the card, at the 0.6B planner's widths (16 query / 8 kv heads, 28 layers of
int8 cache).

    python3 tools/time_decode_attn.py [--batches 1 4 8] [--t-max 1408]
                                      [--lengths 290 673 1056]

Besides the package's own library (as built: one cluster launch per call
where the cache has at most 32 chunks and the grid at most 256 blocks, else
two launches), it builds copies of csrc/decode_attn.cu into
build/kernels/variants/ (one nvcc each, in parallel) that differ in one line:
  two-launch  always the scores launch and the P.V launch
  cluster     the cluster launch at any grid size
  chunk-64    chunks of 64 positions instead of 128
For each batch size B and each library it prints, per kernel, the device time
of one call (a CUDA graph of 20 calls replayed between CUDA events), the eager
time (64 back-to-back wrapper calls after the plan's first 65, so one output
pool is made among them as in a request, and the wrapper's host cost shows
where the device is faster), the host time of one call (calls enqueued on the host
clock), the error against the plain version relative to its peak, and the
bytes bound; beside them ``scaled_dot_product_attention`` on the dequantized
bf16 layer (at B = 1).  B = 1 runs each of ``--lengths``; a larger B spreads
its lengths evenly over their range.  Run it from the root of a checkout: it
times that checkout's package with the inputs and timers of the
``chip_smoke.py`` beside this tool.  Last, the wrapper's host cost at B = 1:
the whole wrapper and its C entry alone.  The card's name and power limit come
first.  Needs one NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMOKE = os.path.join(_ROOT, "chip_smoke.py")
SOURCE = os.path.join(_ROOT, "acestep_tpu_torch", "csrc", "decode_attn.cu")
OUT = os.path.join(_ROOT, "build", "kernels", "variants")
_CLUSTER_IF = "  if ((a.nch + cs - 1) / cs <= NRMAX && a.B * a.Hkv * cs <= CLUSTER_GRID) {\n"
# (anchor in the source, what replaces it)
VARIANTS = {
    "two-launch": (_CLUSTER_IF, "  if (false) {\n"),
    "cluster": (_CLUSTER_IF, "  if ((a.nch + cs - 1) / cs <= NRMAX) {\n"),
    "chunk-64": ("constexpr int CHUNK = 128;", "constexpr int CHUNK = 64;"),
}


def _smoke_helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", _SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_variants():
    """The variants' libraries, name -> ctypes handle."""
    from acestep_tpu_torch.ops.cuda import _build

    os.makedirs(OUT, exist_ok=True)
    src = open(SOURCE).read()
    procs = {}
    for name, (anchor, new) in VARIANTS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"time_decode_attn: anchor not found once in {SOURCE}: {anchor!r}")
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src.replace(anchor, new))
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-shared", "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"time_decode_attn: nvcc failed for {name}:\n{text}")
        handle = ctypes.CDLL(lib)
        for entry, argtypes in _build.SIGNATURES.items():
            if entry.startswith("acestep_decode_attn"):
                fn = getattr(handle, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[name] = handle
    return libs


@contextlib.contextmanager
def using(handle):
    """The wrapper calls ``handle``'s entry points (None: the package's own);
    its plans, whose scratch the library sized, are dropped before and after."""
    from acestep_tpu_torch.ops.cuda import _build, decode_attn

    saved = _build.lib
    decode_attn._memos.clear()
    if handle is not None:
        _build.lib = lambda: handle
    try:
        yield
    finally:
        _build.lib = saved
        decode_attn._memos.clear()


def host_us(fn, n: int = 200) -> float:
    """Host time of one call: ``n`` calls enqueued back to back on the host
    clock, then the card drained (outside the timing)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return host


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", nargs="+", type=int, default=[1, 4, 8])
    ap.add_argument("--t-max", type=int, default=1408)
    ap.add_argument("--lengths", nargs="+", type=int, default=[290, 673, 1056])
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_decode_attn: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke_helpers()
    from acestep_tpu_torch.ops.cuda import _build, decode_attn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    libs = {"as built": None, **build_variants()}
    for b in args.batches:
        if b == 1:
            cases = [[n] for n in args.lengths]
        else:
            cases = [np.linspace(min(args.lengths), max(args.lengths), b).astype(int).tolist()]
        for lengths in cases:
            c = cs.attn_case(b, lengths, 500 + b, t_max=args.t_max)
            a9, a10 = cs.attn_args(c, 0), cs.fused_args(c, 0)
            ref9 = decode_attn.decode_attention_plain(*a9)
            ref10 = decode_attn.decode_attention_fused_plain(*a10)[0]
            bound = sum(cs.attn_bound(1, n, False)[0] for n in lengths)
            line = f"B={b} T={args.t_max} lengths={lengths} (bound {bound * 1e3:.3f} us)"
            if b == 1:
                lib = cs.sdpa_lib(c, 0, lengths[0])
                line += (f"; SDPA device {cs.graph_ms(lib) * 1e3:.2f} us, eager "
                         f"{cs.cuda_ms(lib, iters=decode_attn.POOL) * 1e3:.2f} us, host "
                         f"{host_us(lib):.2f} us")
            print(line, flush=True)
            for tag, handle in libs.items():
                out = []
                with using(handle):
                    for name, fn, a, ref in (
                            ("row 9", decode_attn.decode_attention_int8_stacked, a9, ref9),
                            ("row 10", decode_attn.decode_attention_fused_stacked, a10, ref10)):
                        got = fn(*a)
                        got = got if name == "row 9" else got[0]
                        rel = float((got - ref).abs().max() / ref.abs().max())
                        dev_us = cs.graph_ms(lambda: fn(*a)) * 1e3
                        for _ in range(decode_attn.POOL + 1):   # the plan's first outputs
                            fn(*a)
                        eager_us = cs.cuda_ms(lambda: fn(*a), iters=decode_attn.POOL) * 1e3
                        out.append(f"{name} device {dev_us:.2f} us, eager {eager_us:.2f} us, "
                                   f"host {host_us(lambda: fn(*a)):.2f} us, err/peak {rel:.2e}")
                print(f"  {tag}: " + "; ".join(out), flush=True)
    # the wrapper's host cost at B = 1: the whole wrapper against its C
    # entry alone (the kernel's launch) on the same slots
    c = cs.attn_case(1, [args.lengths[0]], 600, t_max=args.t_max)
    lib = _build.lib()
    for name, fn, a, entry in (
            ("row 9", decode_attn.decode_attention_int8_stacked, cs.attn_args(c, 0),
             lib.acestep_decode_attn),
            ("row 10", decode_attn.decode_attention_fused_stacked, cs.fused_args(c, 0),
             lib.acestep_decode_attn_fused)):
        whole = host_us(lambda: fn(*a))
        plan = next(iter(decode_attn._memos[0][7].values()))
        print(f"{name} host: wrapper {whole:.2f} us a call, of which the C entry alone "
              f"{host_us(lambda: entry(plan.addr)):.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
