"""Parameter-tree quantization: which kernels are quantized, and to what.

The port's counterpart of two JAX modules at once: ``quant/convert.py``
(``quantize_tree`` on the host through numpy) and ``quant/jax_quant.py``
(``quantize_tree_jax``, jitted on the device).  :func:`quantize_tree`
quantizes each kernel with :func:`formats.quantize` on the device its tensor
lives on; ``formats`` holds the per-tensor quantizers that ``jax_quant``'s
``_quantize_*_dev`` compute, bit-exact with the numpy ones wherever they run.
The checkpoint importers (``loader.load_qwen`` / ``load_dit``) take their
decision from :func:`leaf_format` with :func:`importer_policy`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

from acestep_tpu_torch.weights import walk

from .formats import QuantTensor, quantize, supported_format_for

# kernels smaller than this stay in bf16: quant overhead dominates below it
MIN_QUANT_ELEMS = 64 * 1024

_UNQUANTIZED = ("f32", "bf16", "f16")


def default_policy(path: str, arr) -> bool:
    """Quantize 2-D matmul kernels only: no norms, biases, tables or
    embeddings, and no kernel of fewer than ``MIN_QUANT_ELEMS`` elements.
    ``arr`` is a tensor or a numpy array."""
    if getattr(arr, "ndim", 0) != 2 or math.prod(arr.shape) < MIN_QUANT_ELEMS:
        return False
    if path.rsplit("/", 1)[-1] != "kernel":
        return False
    return "embed_tokens" not in path and "norm" not in path


def importer_policy(path: str, arr) -> bool:
    """The kernels the reference importers quantize: :func:`default_policy`
    but the two timestep embeddings and the timbre encoder's ``embed_tokens``
    (``timbre_embed``), which the JAX importers keep unquantized."""
    return default_policy(path, arr) and not any(
        s in path for s in ("/time_embed/", "/time_embed_r/", "/timbre_embed/"))


def leaf_format(path: str, arr, fmt: Optional[str],
                policy: Callable[[str, Any], bool] = default_policy) -> Optional[str]:
    """The format the leaf at ``path`` is quantized to: ``fmt`` where
    ``policy`` picks it, downgraded where its K needs it
    (``supported_format_for``), or None where it stays unquantized."""
    if not fmt or fmt in _UNQUANTIZED or not policy(path, arr):
        return None
    eff = supported_format_for(arr.shape[0], fmt)
    return None if eff in _UNQUANTIZED else eff


def quantize_tree(params: Any, fmt: str,
                  policy: Callable[[str, Any], bool] = default_policy) -> Any:
    """``params`` (dicts / lists / tuples of tensors) with every kernel that
    :func:`leaf_format` gives a format quantized to it, where the kernel lies;
    the quantized weight stays there.  Paths are ``/``-joined keys and list
    indices with a leading ``/``, as the JAX package's walk gives them."""

    def leaf(path, arr):
        if arr is None or isinstance(arr, QuantTensor):
            return arr
        eff = leaf_format(path, arr, fmt, policy)
        return arr if eff is None else quantize(arr, eff)

    return walk(params, leaf)
