"""Layered runtime settings of the port: port of the JAX package's settings.py.

Resolution order (highest wins):
  1. explicit overrides (constructor kwargs / CLI flags)
  2. the process environment (the ACESTEP_TPU_* names the JAX package uses)
  3. a ``.env`` file in the working directory (KEY=VALUE lines, # comments)
  4. built-in defaults

Given a device count, ``load`` adds the mesh shape (dp, tp): the tier
table's tp clamped to the ranks of one host, dp the rest
(``parallel.mesh.mesh_shape``).  It comes from the topology alone; no
environment variable or override sets it.

Only the knobs that the CLI reads through :class:`Settings` are declared,
so ``describe()`` lists nothing inert: the weight format, the DiT megakernel
switch and the int8-activation switch, which the CLI passes to the engine
builders as arguments, and under ``torchrun`` the (dp, tp) that shape its
mesh.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

# knob -> (env var, type, default)
KNOBS = {
    "quant": ("ACESTEP_TPU_QUANT", str, "q8_0"),
    "dit_mega": ("ACESTEP_TPU_DIT_MEGA", bool, False),
    "int8_act": ("ACESTEP_TPU_INT8_ACT", bool, False),
}


def _parse(t, raw: str):
    if t is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return t(raw)


def read_env_file(path: str = ".env") -> Dict[str, str]:
    out: Dict[str, str] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#") or "=" not in ln:
                    continue
                k, _, v = ln.partition("=")
                out[k.strip()] = v.strip().strip('"').strip("'")
    except OSError:
        pass
    return out


@dataclasses.dataclass
class Settings:
    values: Dict[str, Any]
    sources: Dict[str, str]

    @classmethod
    def load(cls, env_file: str = ".env", n_devices: Optional[int] = None,
             local_devices: Optional[int] = None, **overrides) -> "Settings":
        file_env = read_env_file(env_file)
        values: Dict[str, Any] = {}
        sources: Dict[str, str] = {}
        if n_devices is not None:
            from acestep_tpu_torch.parallel.mesh import mesh_shape

            shape = mesh_shape(n_devices, local_devices or n_devices)
            for k, v in zip(("dp", "tp"), shape):
                values[k], sources[k] = v, "topology"
        for name, (env, t, default) in KNOBS.items():
            values[name] = default
            sources[name] = "default"
            if env in file_env:
                try:
                    values[name] = _parse(t, file_env[env])
                    sources[name] = env_file
                except (TypeError, ValueError):
                    pass
            if os.environ.get(env) is not None:
                try:
                    values[name] = _parse(t, os.environ[env])
                    sources[name] = "env"
                except (TypeError, ValueError):
                    pass
        for k, v in overrides.items():
            if k not in KNOBS:
                raise ValueError(f"unknown setting {k!r}: the port reads {sorted(KNOBS)}")
            if v is not None:
                values[k] = v
                sources[k] = "override"
        return cls(values, sources)

    def __getattr__(self, name):
        values = object.__getattribute__(self, "values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def describe(self) -> str:
        lines = ["setting            value        source", "-" * 44]
        for k in sorted(self.values):
            lines.append(f"{k:<18} {str(self.values[k]):<12} {self.sources.get(k, '?')}")
        return "\n".join(lines)
