"""Test-time scaling: PMI reward scoring for ranking batch candidates (port of
the JAX package's scoring.py).

The reward for generated audio codes is the pointwise mutual information
between the conditioning text and the codes, estimated with the LM itself:

    reward = log P(cond | codes) - log P(cond)

computed as teacher-forced log-likelihoods of the conditioning tokens with and
without the codes in context.  Candidates are ranked by reward; metadata recall
checks that the understanding pass recovers the requested metadata.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from acestep_tpu_torch.config import QwenConfig
from acestep_tpu_torch.models import qwen


@torch.no_grad()
def sequence_logprob(params: Dict[str, Any], cfg: QwenConfig, token_ids: torch.Tensor,
                     lengths: torch.Tensor, score_start: torch.Tensor) -> torch.Tensor:
    """Teacher-forced sum of log P(token_t | tokens_<t) over [score_start,
    length) of each right-padded row of ``token_ids`` [B, L] -> [B] f32."""
    b, l = token_ids.shape
    dev = token_ids.device
    valid = (torch.arange(l, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    hidden = qwen.forward(params, cfg, token_ids, valid)
    logits = qwen.lm_logits(params, cfg, hidden).float()                  # [B, L, V]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tok_lp = torch.gather(logp, -1, token_ids[:, 1:, None].long())[..., 0]   # [B, L-1]
    pos = torch.arange(l - 1, device=dev)[None, :]
    # position t of tok_lp predicts token t + 1
    mask = (pos + 1 >= score_start[:, None]) & (pos + 1 < lengths[:, None])
    return (tok_lp * mask.float()).sum(-1)


def pmi_reward(params: Dict[str, Any], cfg: QwenConfig, cond_ids: Sequence[int],
               codes_ids: Sequence[int]) -> float:
    """reward = log P(cond | codes) - log P(cond) (one sequence)."""
    cond, codes = [int(t) for t in cond_ids], [int(t) for t in codes_ids]
    with_ctx, without_ctx = codes + cond, cond
    max_len = max(len(with_ctx), len(without_ctx))
    dev = params["embed_tokens"].device
    ids = torch.tensor([x + [0] * (max_len - len(x)) for x in (with_ctx, without_ctx)],
                       dtype=torch.int64, device=dev)
    lengths = torch.tensor([len(with_ctx), len(without_ctx)], dtype=torch.int64, device=dev)
    # score_start 0 would score token 0 given nothing: 1 at least
    starts = torch.tensor([max(len(codes), 1), 1], dtype=torch.int64, device=dev)
    lp = sequence_logprob(params, cfg, ids, lengths, starts).cpu()
    return float(lp[0] - lp[1])


def calculate_reward_scores(params: Dict[str, Any], cfg: QwenConfig, cond_ids: Sequence[int],
                            candidates: Sequence[Sequence[int]]) -> List[float]:
    """PMI reward per candidate code sequence; higher matches cond better."""
    return [pmi_reward(params, cfg, cond_ids, c) for c in candidates]


def metadata_recall(requested: Dict[str, Any], understood: Dict[str, Any],
                    keys: Optional[Sequence[str]] = None) -> float:
    """Fraction of the requested metadata fields that the understanding pass
    recovered (exact, or contained for values longer than two characters)."""
    keys = keys or [k for k in ("bpm", "keyscale", "timesignature", "language", "genres")
                    if k in requested]
    if not keys:
        return 1.0
    hit = 0
    for k in keys:
        want = str(requested.get(k, "")).strip().lower()
        got = str(understood.get(k, "")).strip().lower()
        if want and (want == got or (want in got if len(want) > 2 else False)):
            hit += 1
    return hit / len(keys)


def rank_candidates(params: Dict[str, Any], cfg: QwenConfig, cond_ids: Sequence[int],
                    candidates: Sequence[Sequence[int]]) -> List[int]:
    """Indices of the candidates sorted best-first by PMI reward."""
    scores = calculate_reward_scores(params, cfg, cond_ids, candidates)
    return [int(i) for i in np.argsort(scores)[::-1]]
