"""Build and load the port's CUDA kernels.

Every ``acestep_tpu_torch/csrc/*.cu`` source is compiled by its own plain
``nvcc`` process, all started together, and the objects are linked into one
shared library with a C interface, which is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o build/kernels/<hash>/<source>.o csrc/<source>.cu      (each, in parallel)
    nvcc -shared -o build/kernels/<hash>/libacestep_kernels.so build/kernels/<hash>/*.o

No source includes PyTorch's headers, so the build takes seconds, not the
minutes of ``torch.utils.cpp_extension``.  The library lands in ``build/kernels/``
at the repository root (git-ignored), under a directory named by the hash of
the sources and flags: it is rebuilt only when a source changes.  The build runs
at first use, never at import, so the CPU tests can import every module.

Each C entry point takes device pointers, ints and the CUDA stream (all
pointers and the stream as ``ctypes.c_void_p``) and returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
LIB_NAME = "libacestep_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: name -> argtypes (all return int)
SIGNATURES = {
    # one pointer to the call's 8-byte slots (csrc/qmm_wgmma.cu: acestep_qmm)
    "acestep_qmm": [_P],
    # (format 0..3, bm, splits) -> clusters the card holds at once (<= 0: failed)
    "acestep_qmm_clusters": [_I] * 3,
    # a, b, out, stream
    "acestep_wgmma_tile_check": [_P] * 4,
    # x, stages, vec, out, N, L, C, dilation, stream (csrc/vae_resunit.cu)
    "acestep_vae_res_unit": [_P] * 4 + [_I] * 4 + [_P],
    "acestep_vae_res_unit_tf32": [_P] * 4 + [_I] * 4 + [_P],
    # x, stages, vec, out, scratch, sync, N, L, C, stream
    "acestep_vae_res_trio": [_P] * 6 + [_I] * 3 + [_P],
    "acestep_vae_res_trio_tf32": [_P] * 6 + [_I] * 3 + [_P],
    # shared-memory bytes of one block: (C, dilation) / (C)
    "acestep_vae_res_unit_smem": [_I, _I],
    "acestep_vae_res_trio_smem": [_I],
    # one pointer to the call's 8-byte slots (csrc/decode_attn.cu: enum Slot)
    "acestep_decode_attn": [_P],
    "acestep_decode_attn_fused": [_P],
    # (B, Hq, Hkv, T) -> floats of scratch (< 0: not taken)
    "acestep_decode_attn_scratch": [_I] * 4,
    # one pointer to the call's 8-byte slots (csrc/decode_mega.cu: enum Slot)
    "acestep_decode_mega": [_P],
    # (B) -> blocks of the cooperative grid (< 0: the occupancy query failed)
    "acestep_decode_mega_grid": [_I],
    # one pointer to the call's 8-byte slots (csrc/qmm_int8.cu: acestep_qmm_int8)
    "acestep_qmm_int8": [_P],
    # (M, K, bn, splits) -> shared-memory bytes of one block (< 0: no such plan)
    "acestep_qmm_int8_smem": [_I] * 4,
    # one pointer to the call's 8-byte slots (csrc/dit_mega.cu: enum Slot)
    "acestep_dit_mega": [_P],
    # () -> shared-memory bytes of one block
    "acestep_dit_mega_smem": [],
    # () -> blocks of the launch: 4 x the clusters the card holds (< 0: failed)
    "acestep_dit_mega_grid": [],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc build (None: cached)


@dataclasses.dataclass
class Counted:
    """A kernel's identity in the run's record and its launch counts
    (``shapes`` counts launches by the shape key its wrapper gives)."""

    name: str
    source: str
    replaces: str
    launches: int = 0
    shapes: Counter = dataclasses.field(default_factory=Counter)

    def count(self, shape) -> None:
        self.launches += 1
        self.shapes[shape] += 1

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
                       "are built on the machine with the card")


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), LIB_NAME)


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    work = os.path.dirname(out)
    os.makedirs(work, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [os.path.join(work, f"{os.path.basename(p)}.{tag}.o") for p in cu]
    t0 = time.perf_counter()
    procs = []
    for src, obj in zip(cu, objs):
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []), "-I", CSRC_DIR,
               "-c", "-o", obj, src]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    outputs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    link = [nvcc, "-shared", "-o", f"{out}.{tag}", *objs]
    if all(rc == 0 for _, _, rc in outputs):
        proc = subprocess.run(link, capture_output=True, text=True)
        outputs.append((link, proc.stdout + proc.stderr, proc.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    failed = [(cmd, text, rc) for cmd, text, rc in outputs if rc != 0]
    if failed:
        raise RuntimeError("\n".join(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}"
                                     for cmd, text, rc in failed))
    if verbose:
        print("".join(text for _, text, _ in outputs), flush=True)
    os.replace(f"{out}.{tag}", out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int
    (read without making a ``torch.cuda.Stream`` object: a few us less a
    launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
