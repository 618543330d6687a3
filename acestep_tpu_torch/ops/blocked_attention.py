"""Self-attention masks of the DiT and its encoders: sliding-window (banded)
and full.

The JAX package's ops/blocked_attention.py is plain XLA code, not a Pallas
kernel: ``banded_attention`` for ``sliding_attention`` layers (bidirectional
band |i - j| <= window) and ``flash_attention`` for ``full_attention`` layers,
each with a key-validity mask, and its DiT takes them only from 1536 tokens on
(dense masked attention below).  This port computes the same functions as dense
masked attention (``ops.nn.attention``) with the masks built here once per
forward; that is exact and small at the first slice's lengths (a 10 s clip is
128 DiT tokens).  Blocking them to O(T * window) memory belongs to the
long-song slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from acestep_tpu_torch.ops.nn import make_attention_mask


def self_attention_masks(
    seq_len: int, window: int, kv_valid: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(sliding mask, full mask) as additive f32 [B|1, 1, T, T]; the full mask is
    None when every key is valid."""
    sliding = make_attention_mask(seq_len, seq_len, kv_valid=kv_valid,
                                  sliding_window=window, device=device)
    full = make_attention_mask(seq_len, seq_len, kv_valid=kv_valid)
    return sliding, full
