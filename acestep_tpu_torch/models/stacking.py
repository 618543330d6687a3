"""Layer stacking helpers shared by the transformer stacks.

A stack's ``layers`` is a list of per-layer dicts, or one dict whose leaves
carry a leading layer axis (quantized kernels as stacked QuantTensors
``[L, K, N]``).  Stacked layers are walked by index; each quantized kernel is
handed to ``linear`` as a :class:`StackedWeight`, so the kernel reads layer
``li`` in place.
"""

from __future__ import annotations

import torch

from acestep_tpu_torch.ops.qlinear import StackedWeight
from acestep_tpu_torch.quant import QuantTensor, stack_layers


def _stack(vals):
    if isinstance(vals[0], dict):
        return {k: _stack([v[k] for v in vals]) for k in vals[0]}
    if isinstance(vals[0], QuantTensor):
        return stack_layers(vals)
    return torch.stack(vals)


def stack_layer_params(layers):
    """List of per-layer dicts -> one dict with a leading layer axis."""
    return _stack(list(layers))


def layer_view(stacked, li: int):
    """Layer ``li`` of stacked params: small tensors indexed, quantized kernels
    as :class:`StackedWeight` handles (read in place by the kernel)."""
    if isinstance(stacked, dict):
        return {k: layer_view(v, li) for k, v in stacked.items()}
    if isinstance(stacked, QuantTensor):
        return StackedWeight(stacked, li)
    return stacked[li]


def first_layers(stacked, n: int):
    """The first ``n`` layers of stacked params (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: first_layers(v, n) for k, v in stacked.items()}
    if isinstance(stacked, QuantTensor):
        return stacked.map(lambda a: a[:n])
    return stacked[:n]


def num_layers(layers) -> int:
    if isinstance(layers, list):
        return len(layers)
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.num_layers if isinstance(layers, QuantTensor) else layers.shape[0]


def iter_layers(layers):
    if isinstance(layers, list):
        yield from layers
    else:
        for li in range(num_layers(layers)):
            yield layer_view(layers, li)


def unstack_layer_params(stacked):
    """Inverse of :func:`stack_layer_params`: one dict with a leading layer
    axis -> a list of per-layer dicts (views, no copy), the layout a
    checkpoint's ``layers`` and a LoRA adapter have."""

    def index(t, li):
        if isinstance(t, dict):
            return {k: index(v, li) for k, v in t.items()}
        return t.layer(li) if isinstance(t, QuantTensor) else t[li]

    return [index(stacked, li) for li in range(num_layers(stacked))]
