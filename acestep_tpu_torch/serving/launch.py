"""Engine and LM construction for serving: from a converted checkpoint
directory, or random weights without one.

A checkpoint directory holds ``dit``, ``vae`` and ``text_encoder`` parameter
files as ``loader.save_params`` writes them (``<name>.safetensors`` plus
``<name>.json``), each beside an optional ``<name>.config.json`` (the model's
config; the flagship defaults where it is missing).  Quantized weights are
served in the format they were saved in.  An LM planner adds ``lm`` parameter
files, ``lm.config.json`` and the tokenizer's ``tokenizer.json`` (read with the
``tokenizers`` package); the audio-code bridge adds ``codec`` parameter files
(``models/codec``'s tree as ``loader.save_params`` writes it).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.lm_pipeline import LMPipeline, TokenizerJsonAdapter
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


def build_lm(checkpoint: Optional[str], device=None, **knobs) -> Optional[LMPipeline]:
    """The LM planner of ``checkpoint`` on ``device`` (the card by default):
    ``lm`` parameters, ``lm.config.json`` and ``tokenizer.json``.  None when the
    checkpoint has no LM: the server then runs the engine alone.  ``knobs`` go
    to :class:`LMPipeline`."""
    if not checkpoint:
        return None
    lm_dir = os.path.join(checkpoint, "lm")
    tok_path = os.path.join(checkpoint, "tokenizer.json")
    if not os.path.exists(lm_dir + ".safetensors") or not os.path.exists(tok_path):
        return None
    with open(os.path.join(checkpoint, "lm.config.json")) as f:
        cfg = QwenConfig.from_dict(json.load(f))
    dev = resolve_device(device)
    return LMPipeline(loader.load_params(lm_dir, device=dev), cfg,
                      TokenizerJsonAdapter(tok_path), device=dev, **knobs)


def build_codec(checkpoint: Optional[str], device=None):
    """The codec bridge's parameters of ``checkpoint`` (``codec.safetensors`` and
    ``codec.json``) on ``device`` (the card by default); None when the
    checkpoint carries none, and the LM code hints then stay off."""
    if not checkpoint:
        return None
    codec_dir = os.path.join(checkpoint, "codec")
    if not os.path.exists(codec_dir + ".safetensors"):
        return None
    return loader.load_params(codec_dir, device=resolve_device(device))
