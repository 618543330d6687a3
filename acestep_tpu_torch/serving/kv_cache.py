"""Quantized KV cache for the LM planner (port of the JAX package's
serving/kv_cache.py, same layout and numerics).

Dense and length-bucketed: K/V are stored per (layer, batch, kv head, position)
as int8 (the default) or float8_e4m3fn, with one f32 scale per vector:

  k, v              [L, B, Hkv, T, D]  int8 (or float8_e4m3fn)
  k_scale, v_scale  [L, B, Hkv, T]     f32
  length            [B]                int32, valid positions per sequence

The vectors are quantized by ``quant.kv.quantize_kv`` (int8 ``amax / 127``
scales, fp8 ``amax / 448``).  The decode kernels stream int8 only, so an fp8
cache always takes the plain layer-scan decode (serving/lm.py), as in the JAX
package.

Unlike JAX arrays the tensors here are mutable: the decode loop writes each
new token's K/V into the cache in place, so callers that keep a cache
(``PrefixCache``) hand out :meth:`KVCache.clone` copies.
"""

from __future__ import annotations

import dataclasses
import torch

from acestep_tpu_torch.quant.kv import KV_DTYPES, check_kv_dtype, quantize_kv  # noqa: F401


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def kv_dtype(self) -> str:
        return "int8" if self.k.dtype == torch.int8 else "fp8"

    def clone(self) -> "KVCache":
        return KVCache(self.k.clone(), self.v.clone(), self.k_scale.clone(),
                       self.v_scale.clone(), self.length.clone())


def round_len(n: int, mult: int = 128) -> int:
    """Round a cache time-axis length up to a multiple of ``mult`` (the decode
    kernels walk the cache in 128-position blocks; padding slots are masked by
    ``length``)."""
    return ((int(n) + mult - 1) // mult) * mult


def init_cache(n_layers: int, batch: int, n_kv: int, max_len: int, head_dim: int,
               kv_dtype: str = "int8", device=None) -> KVCache:
    qt = KV_DTYPES[check_kv_dtype(kv_dtype)]
    shape = (n_layers, batch, n_kv, max_len)
    return KVCache(
        k=torch.zeros(shape + (head_dim,), dtype=qt, device=device),
        v=torch.zeros(shape + (head_dim,), dtype=qt, device=device),
        k_scale=torch.zeros(shape, dtype=torch.float32, device=device),
        v_scale=torch.zeros(shape, dtype=torch.float32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def grow_cache(cache: KVCache, new_max_len: int) -> KVCache:
    """Zero-pad the time axis to ``new_max_len`` (a cached prefill sized for
    one phase grows to hold the next phase's prompt and codes)."""
    pad = new_max_len - cache.max_len
    if pad <= 0:
        return cache

    def grow(a):
        shape = list(a.shape)
        shape[3] = pad
        return torch.cat([a, torch.zeros(shape, dtype=a.dtype, device=a.device)], dim=3)

    return KVCache(grow(cache.k), grow(cache.v), grow(cache.k_scale), grow(cache.v_scale),
                   cache.length)


def broadcast_cache(cache: KVCache, batch: int) -> KVCache:
    """Tile a batch-1 cache to ``batch`` rows (one shared prompt prefill feeds
    a batch of candidate decodes)."""
    if cache.k.shape[1] == batch:
        return cache
    if cache.k.shape[1] != 1:
        raise ValueError("can only broadcast a batch-1 cache")
    return KVCache(cache.k.repeat(1, batch, 1, 1, 1), cache.v.repeat(1, batch, 1, 1, 1),
                   cache.k_scale.repeat(1, batch, 1, 1), cache.v_scale.repeat(1, batch, 1, 1),
                   cache.length.repeat(batch))


def advance(cache: KVCache, active: torch.Tensor) -> KVCache:
    """Bump the lengths of the active (unfinished) sequences."""
    return KVCache(cache.k, cache.v, cache.k_scale, cache.v_scale,
                   cache.length + active.to(torch.int32))
