"""Environment report of the port: the CUDA counterpart of the JAX package's
tools/check_env.py.

    python -m acestep_tpu_torch.check_env [--json] [--build]

Reports the Python, torch and CUDA versions; each visible card's name, power
limit (nvidia-smi), memory and compute capability; ``nvcc``'s path and
version and CUTLASS's headers (none of the kernels includes them); whether the
kernel library (``ops/cuda/_build``: the six ``csrc/*.cu`` sources, one
library per hash of the sources and flags) is built for the current sources,
and with ``--build`` builds it; whether the converter's native quantizer
(``native/``) compiles; the (dp, tp) mesh shape of the visible cards
(``parallel.mesh.mesh_shape``); and the resolved settings.

Exit code 0 when the port can run: a CUDA card of compute capability 9.0
(the kernels are built for sm_90a) and ``nvcc``.  Otherwise 1, the report
naming what is missing.  Unlike the JAX tool, which accepts any backend, there
is no fallback: the plain PyTorch versions serve the CPU tests only.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

CUTLASS_DIRS = ("CUTLASS_HOME", "CUTLASS_PATH")
CUTLASS_DEFAULT = "/usr/local/cutlass"


def _nvidia_smi() -> List[List[str]]:
    """Rows of ``nvidia-smi --query-gpu=name,power.limit`` (empty without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [[c.strip() for c in line.split(",")] for line in out.stdout.strip().splitlines()]


def _nvcc() -> Optional[Dict[str, str]]:
    from acestep_tpu_torch.ops.cuda import _build

    try:
        path = _build._nvcc()
    except RuntimeError:
        return None
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return {"path": path, "version": lines[-1] if lines else ""}


def _cutlass() -> Optional[str]:
    roots = [os.environ[v] for v in CUTLASS_DIRS if os.environ.get(v)] + [CUTLASS_DEFAULT]
    for root in roots:
        inc = os.path.join(root, "include")
        if os.path.isfile(os.path.join(inc, "cutlass", "cutlass.h")):
            return inc
    return None


def _kernels(build: bool, problems: List[str]) -> Dict[str, Any]:
    from acestep_tpu_torch.ops.cuda import _build

    lib = _build.library_path()
    info: Dict[str, Any] = {"library": lib, "hash": os.path.basename(os.path.dirname(lib))}
    if build:
        t = time.perf_counter()
        try:
            _build.build()
            info["build_seconds"] = round(time.perf_counter() - t, 3)
        except RuntimeError as exc:
            info["build_error"] = str(exc)
            problems.append("the kernels do not build (see kernels.build_error)")
    built = os.path.exists(lib)
    info["sources"] = [{"source": os.path.relpath(p, os.path.dirname(_build.CSRC_DIR)),
                        "built": built}
                       for p in _build._sources() if p.endswith(".cu")]
    return info


def _native() -> Dict[str, Any]:
    from acestep_tpu_torch import native

    try:
        return {"compiles": True, "path": native.build()}
    except RuntimeError as exc:
        return {"compiles": False, "error": str(exc)}


def collect(build: bool = False) -> Dict[str, Any]:
    """The report; its ``problems`` list is empty when the port can run."""
    import torch

    from acestep_tpu_torch.parallel.mesh import mesh_shape
    from acestep_tpu_torch.settings import Settings

    problems: List[str] = []
    info: Dict[str, Any] = {"python": sys.version.split()[0], "torch": torch.__version__,
                            "cuda": torch.version.cuda}
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    smi = _nvidia_smi()
    cards = []
    for i in range(n):
        prop = torch.cuda.get_device_properties(i)
        cards.append({"index": i, "name": prop.name,
                      "power_limit": smi[i][1] if i < len(smi) and len(smi[i]) > 1 else None,
                      "memory_gib": round(prop.total_memory / 2**30, 2),
                      "capability": f"{prop.major}.{prop.minor}"})
    info["cards"] = cards
    if not n:
        problems.append("no CUDA card (torch.cuda.is_available() is False)")
    for c in cards:
        if c["capability"] != "9.0":
            problems.append(f"card {c['index']} ({c['name']}) is sm_{c['capability']}, "
                            "not sm_90: the kernels are built for sm_90a")
    info["nvcc"] = _nvcc()
    if info["nvcc"] is None:
        problems.append("nvcc not found (PATH or $CUDA_HOME/bin)")
    info["cutlass_include"] = _cutlass()
    info["kernels"] = _kernels(build and info["nvcc"] is not None, problems)
    info["native_quant"] = _native()
    if n:
        info["mesh_shape"] = list(mesh_shape(n, n))
    info["settings"] = Settings.load(n_devices=n or None, local_devices=n or None).describe()
    info["problems"] = problems
    return info


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    unknown = [a for a in args if a not in ("--json", "--build")]
    if unknown:
        print(f"usage: python -m acestep_tpu_torch.check_env [--json] [--build] "
              f"(unknown {unknown})", file=sys.stderr)
        return 2
    info = collect(build="--build" in args)
    if "--json" in args:
        print(json.dumps(info, indent=2, default=str))
    else:
        for k, v in info.items():
            if k == "settings":
                print(f"{k}:\n{v}")
            else:
                print(f"{k}: {v}")
    return 1 if info["problems"] else 0


if __name__ == "__main__":
    sys.exit(main())
