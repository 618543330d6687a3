"""Layered runtime settings of the port: port of the JAX package's settings.py
(without its device-count tiers: the port serves on one card).

Resolution order (highest wins):
  1. explicit overrides (constructor kwargs / CLI flags)
  2. the process environment (the ACESTEP_TPU_* names the JAX package uses)
  3. a ``.env`` file in the working directory (KEY=VALUE lines, # comments)
  4. built-in defaults

Only the knobs that the CLI reads through :class:`Settings` are declared,
so ``describe()`` lists nothing inert: the weight format, the DiT megakernel
switch and the int8-activation switch, which the CLI passes to the engine
builders as arguments.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

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
    def load(cls, env_file: str = ".env", **overrides) -> "Settings":
        file_env = read_env_file(env_file)
        values: Dict[str, Any] = {}
        sources: Dict[str, str] = {}
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
