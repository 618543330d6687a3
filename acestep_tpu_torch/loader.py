"""Parameter trees to and from disk: ``<path>.safetensors`` plus a ``<path>.json``
manifest, the same files the JAX package's ``loader.save_params`` /
``load_params`` write and read.

Leaves are flattened to ``/``-joined names (list items by index).  A quantized
weight stores each field as ``<name>#<field>`` and its manifest entry
``{"type": "quant", "fmt", "shape", "fields", ["bf16_fields"]}``; a bf16 leaf is
stored as raw bf16 bits (``{"type": "bf16"}``), any other leaf as it is
(``{"type": "array"}``).  Loading rebuilds the nesting and turns dicts whose
keys are all digits back into lists.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile, save_safetensors
from acestep_tpu_torch.weights import flatten


def _to_numpy(t: torch.Tensor):
    """(array, is_bf16): bf16 tensors as their raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _from_numpy(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    arr = np.array(arr)                     # own, writable copy of the mapped bytes
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save_params(path: str, params: Any) -> None:
    """Write a parameter tree (QuantTensors included) to ``<path>.safetensors``
    and ``<path>.json``."""
    tensors: Dict[str, np.ndarray] = {}
    dtype_map: Dict[str, str] = {}
    leaves: Dict[str, Any] = {}
    for name, leaf in flatten(params).items():
        if leaf is None:
            continue
        if isinstance(leaf, QuantTensor):
            entry = {"type": "quant", "fmt": leaf.fmt, "shape": list(leaf.shape),
                     "fields": []}
            for f, a in leaf.fields().items():
                arr, bf16 = _to_numpy(a)
                if bf16:
                    entry.setdefault("bf16_fields", []).append(f)
                    dtype_map[f"{name}#{f}"] = "BF16"
                tensors[f"{name}#{f}"] = arr
                entry["fields"].append(f)
            leaves[name] = entry
            continue
        arr, bf16 = _to_numpy(leaf)
        tensors[name] = arr
        if bf16:
            dtype_map[name] = "BF16"
        leaves[name] = {"type": "bf16" if bf16 else "array"}
    save_safetensors(path + ".safetensors", tensors, dtype_map)
    with open(path + ".json", "w") as f:
        json.dump({"leaves": leaves}, f)


def load_params(path: str, device="cpu") -> Any:
    """Read a tree written by :func:`save_params` (or by the JAX package's
    ``save_params``), moving each tensor to ``device`` as it is read."""
    st = SafetensorsFile(path + ".safetensors")
    with open(path + ".json") as f:
        manifest = json.load(f)
    root: Dict[str, Any] = {}
    for name, entry in manifest["leaves"].items():
        if entry["type"] == "quant":
            bf16 = set(entry.get("bf16_fields", []))
            leaf = QuantTensor(entry["fmt"], tuple(entry["shape"]), **{
                f: _from_numpy(st.tensor(f"{name}#{f}"), f in bf16, device)
                for f in entry["fields"]})
        else:
            leaf = _from_numpy(st.tensor(name), entry["type"] == "bf16", device)
        *parents, last = name.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)
