"""LoRA adapters switched on a serving engine at run time: port of the JAX
package's lora_runtime.py (register, activate, scale, deactivate, unregister
without a restart).

The runtime keeps the pristine unstacked DiT tree, as a checkpoint's ``dit``
files hold it (adapters train against the per-layer 2-D kernels).  A rebuild
merges the active adapters into it (``training.lora.apply_lora``; quantized
kernels are requantized in their format on their device) and hands the engine
the layout ``AceStepEngine.__init__`` builds:
``precast_quant_scales(fuse_params(stack_params(tree)))``, or under a
tensor-parallel mesh this rank's shards of the unfused tree
(lora_runtime.py:108-111).  Deactivating every
adapter rebuilds from the pristine tree, so the engine's weights, and its
output, are the base's bit for bit.

Nothing on the card keeps state made from the old weights: the kernels'
plan caches (``ops/cuda/qmm.py``, ``qmm_int8.py``, ``dit_mega.py``) are keyed
by shapes, the dequant-matmul's pointer memo lives on the weight object it was
made from, and the engine's cross-attention K/V are computed per request.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from acestep_tpu_torch import loader


class LoRARuntime:
    """The engine's base DiT tree and its adapter registry.

    ``base_params`` is the unstacked DiT tree (``serving.launch.build_engine``
    returns it beside the engine); adapters are read onto its device."""

    def __init__(self, engine, base_params: Any):
        self.engine = engine
        self._base = base_params                    # pristine unstacked tree
        self._lock = threading.Lock()
        self._registry: Dict[str, Dict[str, Any]] = {}   # name -> {lora, alpha, scale}
        self._active: List[str] = []

    # -- registry ------------------------------------------------------------

    def register(self, name: str, lora_params: Any, alpha: float = 16.0) -> None:
        """Add an adapter to the registry (it stays inactive)."""
        with self._lock:
            self._registry[name] = {"lora": lora_params, "alpha": alpha, "scale": 1.0}

    def register_from_dir(self, name: str, path: str, alpha: float = 16.0) -> None:
        """Read a saved adapter (``loader.save_params`` files at ``path``, of
        either package) onto the engine's device and register it."""
        self.register(name, loader.load_params(path, device=self.engine.device), alpha)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._registry.pop(name, None)
            if name in self._active:
                self._active.remove(name)
                self._rebuild_locked()

    def list_adapters(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {n: {"alpha": e["alpha"], "scale": e["scale"], "active": n in self._active}
                    for n, e in self._registry.items()}

    # -- activation ----------------------------------------------------------

    def activate(self, name: str, scale: float = 1.0) -> None:
        """Merge an adapter into the engine (on top of any already active)."""
        with self._lock:
            if name not in self._registry:
                raise KeyError(f"unknown adapter: {name}")
            self._registry[name]["scale"] = scale
            if name not in self._active:
                self._active.append(name)
            self._rebuild_locked()

    def set_scale(self, name: str, scale: float) -> None:
        with self._lock:
            if name not in self._registry:
                raise KeyError(f"unknown adapter: {name}")
            self._registry[name]["scale"] = scale
            if name in self._active:
                self._rebuild_locked()

    def deactivate(self, name: str) -> None:
        with self._lock:
            if name in self._active:
                self._active.remove(name)
                self._rebuild_locked()

    def deactivate_all(self) -> None:
        with self._lock:
            self._active.clear()
            self._rebuild_locked()

    # -- merge ---------------------------------------------------------------

    def merged_params(self) -> Any:
        """The unstacked tree with every active adapter merged, in order."""
        from acestep_tpu_torch.training.lora import apply_lora, scale_lora

        params = self._base
        for name in self._active:
            entry = self._registry[name]
            lora = entry["lora"]
            if entry["scale"] != 1.0:
                lora = scale_lora(lora, entry["scale"])
            params = apply_lora(params, lora, alpha=entry["alpha"])
        return params

    def _rebuild_locked(self) -> None:
        from acestep_tpu_torch.models import dit
        from acestep_tpu_torch.ops.qlinear import precast_quant_scales

        stacked = dit.stack_params(self.merged_params())
        mesh = getattr(self.engine, "mesh", None)
        if mesh is None or mesh.tp == 1:
            stacked = dit.fuse_params(stacked)
        self.engine.dit_params = precast_quant_scales(stacked)
        if mesh is not None:
            from acestep_tpu_torch.parallel.sharding import shard_params

            self.engine.dit_params = shard_params(self.engine.dit_params, mesh)
