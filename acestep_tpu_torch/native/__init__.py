"""The converter's host-side C++ quantizers (``quant_native.cpp``), built with
g++ and imported as an extension module.

The module is compiled at first use, never at import, into
``build/native/<hash>/`` at the repository root (git-ignored, beside the CUDA
library of ``ops/cuda/_build.py``), under a directory named by the hash of the
source, the flags and the Python headers: it is rebuilt only when one of them
changes, and nothing is written into the source tree.  A failed build raises
with g++'s output; there is no quiet numpy fallback.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "quant_native.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
MODULE = "_quant_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_native = None


def _include() -> str:
    return sysconfig.get_paths()["include"]


def module_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(" ".join(CXX_FLAGS + (_include(), suffix)).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], MODULE + suffix)


def build() -> str:
    """Compile the extension unless it exists for the current source; returns
    its path.  Raises RuntimeError with g++'s output when the build fails."""
    out = module_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, f"-I{_include()}", SOURCE, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the native quantizers are built with the "
                           "system's C++ compiler") from exc
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def get_native():
    """The extension module (built on first use)."""
    global _native
    if _native is None:
        spec = importlib.util.spec_from_file_location(MODULE, build())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _native = mod
    return _native
