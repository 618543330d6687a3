"""Engine construction for serving: from a converted checkpoint directory, or
random weights without one.

A checkpoint directory holds ``dit``, ``vae`` and ``text_encoder`` parameter
files as ``loader.save_params`` writes them (``<name>.safetensors`` plus
``<name>.json``), each beside an optional ``<name>.config.json`` (the model's
config; the flagship defaults where it is missing).  Quantized weights are
served in the format they were saved in.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.pipeline import AceStepEngine, build_random_engine, resolve_device


def _load_cfg(checkpoint: str, name: str, cls):
    path = os.path.join(checkpoint, f"{name}.config.json")
    if not os.path.exists(path):
        return cls()
    with open(path) as f:
        return cls.from_dict(json.load(f))


def build_engine(checkpoint: Optional[str] = None, quant: str = "q8_0",
                 device=None, *, dit_mega: bool = False,
                 int8_act: bool = False) -> AceStepEngine:
    """The engine of ``checkpoint`` on ``device`` (the card by default); without a
    checkpoint, a full-width random-weight engine quantized to ``quant``
    (``"bf16"`` for none).  ``dit_mega`` / ``int8_act`` as
    :class:`AceStepEngine`."""
    if not checkpoint:
        return build_random_engine(device=device, quant=None if quant == "bf16" else quant,
                                   dit_mega=dit_mega, int8_act=int8_act)
    dev = resolve_device(device)

    def params(name):
        return loader.load_params(os.path.join(checkpoint, name), device=dev)

    return AceStepEngine(params("dit"), _load_cfg(checkpoint, "dit", DiTConfig),
                         params("vae"), _load_cfg(checkpoint, "vae", VAEConfig),
                         params("text_encoder"),
                         _load_cfg(checkpoint, "text_encoder", QwenConfig), device=dev,
                         dit_mega=dit_mega, int8_act=int8_act)
