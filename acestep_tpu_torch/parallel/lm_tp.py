"""Tensor-parallel LM planner serving: port of the JAX package's
parallel/lm_tp.py (the reference's nano-vllm TP analog).

The Megatron layout, one process a rank:

  * the fused qkv / gate-up weights are fused **rank-major** (rank r's
    contiguous column shard is ``[q_r|k_r|v_r]`` / ``[gate_r|up_r]``), so the
    rank's split of its qkv output with its local head counts is exact;
  * o_proj / down_proj are row-parallel, one all-reduce a half-block
    (serving/lm.py ``group``);
  * the KV cache holds the rank's KV heads (nkv / tp): the prefix-cache flow
    (prefill, grow, extend, broadcast, decode) runs on each rank's own cache;
  * the quantized head is column-sharded over its 2048-padded vocab and the
    logits are gathered in rank order, so every rank holds the same logits and
    samples the same token from an equally seeded generator;
  * the reduced codes-phase head is cut from the whole head (gathered once per
    (range, EOS) from the ranks' shards) and handed to the decode loop as this
    rank's column shard of it (``head_red_override``).

The decode megakernel stays off under TP; the layer scan runs the
decode-attention kernels at the local KV heads.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from acestep_tpu_torch.config import QwenConfig
from acestep_tpu_torch.ops.qlinear import concat_weights_n, precast_quant_scales
from acestep_tpu_torch.parallel.distributed import all_gather_cat
from acestep_tpu_torch.parallel.mesh import Mesh
from acestep_tpu_torch.parallel.sharding import row_granule, shard_params, shard_weight
from acestep_tpu_torch.parallel.tp import local_cfg
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.serving import kv_cache as kvc
from acestep_tpu_torch.serving import lm as lm_serving
from acestep_tpu_torch.serving.kv_cache import KVCache
from acestep_tpu_torch.serving.lm import SamplingParams


def _ncols(w) -> int:
    return w.shape[1] if isinstance(w, QuantTensor) else int(w.shape[-1])


def _slice_cols(w, lo: int, hi: int):
    """Output columns [lo, hi) of a kernel (tensor or QuantTensor, stacked
    [L, ...] too): every quant field packs along K, so each cuts along N."""
    if isinstance(w, QuantTensor):
        return QuantTensor(w.fmt, (w.shape[0], hi - lo),
                           **{f: a[..., lo:hi] for f, a in w.fields().items()})
    return w[..., lo:hi]


def _rank_major(ws, tp: int):
    """Fuse kernels column-wise in rank-major order: rank r's contiguous
    shard of the result is [w0_r | w1_r | ...].  At tp = 1 this is the plain
    serving fusion."""
    for w in ws:
        if _ncols(w) % tp:
            raise ValueError(f"TP={tp} must divide every fused output width, got {_ncols(w)}")
    if tp == 1:
        return concat_weights_n(ws)
    parts = []
    for r in range(tp):
        for w in ws:
            n = _ncols(w) // tp
            parts.append(_slice_cols(w, r * n, (r + 1) * n))
    return concat_weights_n(parts)


def _validate_row_parallel(name: str, w, tp: int) -> None:
    k = w.shape[0] if isinstance(w, QuantTensor) else int(w.shape[-2])
    g = row_granule(w)
    if k % tp or (k // tp) % g:
        raise ValueError(
            f"{name}: K={k} cannot be row-sharded {tp} ways with "
            f"{getattr(w, 'fmt', 'dense')} (per-rank K must be a multiple of "
            f"{g}); use a smaller tp or q8_0 for this weight")


def prepare_tp_params(params: Dict[str, Any], cfg: QwenConfig, mesh: Mesh) -> Dict[str, Any]:
    """Fuse rank-major, validate and shard LM serving params: this rank's tree.

    Input: stacked, unfused params (q_proj / k_proj / ... apart) with the
    quantized head already ensured (``lm.ensure_quantized_head`` pads the
    vocab to a multiple of 2048, which any tp <= 16 divides)."""
    tp = mesh.tp
    layers = params.get("layers")
    if isinstance(layers, list):
        raise ValueError("prepare_tp_params requires stacked layer params")
    if "qkv_proj" in layers:
        raise ValueError("params already fused: pass pre-fusion params")
    if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp:
        raise ValueError(f"tp={tp} must divide attention heads "
                         f"({cfg.num_attention_heads}/{cfg.num_key_value_heads})")
    new_layers = dict(layers)
    new_layers["qkv_proj"] = {"kernel": _rank_major(
        [layers["q_proj"]["kernel"], layers["k_proj"]["kernel"],
         layers["v_proj"]["kernel"]], tp)}
    new_layers["gateup_proj"] = {"kernel": _rank_major(
        [layers["gate_proj"]["kernel"], layers["up_proj"]["kernel"]], tp)}
    for k in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        del new_layers[k]
    for k in lm_serving._NORMS:
        new_layers[k] = new_layers[k].float()
    _validate_row_parallel("o_proj", new_layers["o_proj"]["kernel"], tp)
    _validate_row_parallel("down_proj", new_layers["down_proj"]["kernel"], tp)
    out = dict(params)
    out["layers"] = new_layers
    head = out.get("lm_head")
    if head is not None and _ncols(head["kernel"]) % tp:
        raise ValueError(f"lm_head width {_ncols(head['kernel'])} not divisible by tp={tp}")
    return shard_params(precast_quant_scales(out), mesh)


class LMTPContext:
    """This rank's sharded LM params and the serving entry points over the
    mesh's tp group, with ``serving.lm``'s signatures: ``prefill``,
    ``extend_prefill``, ``decode_step``, ``decode_from_state`` and
    ``generate``.  Caches are the rank's (``init_cache``: nkv / tp heads).
    ``knobs``: ``decode_attn`` / ``int8_act`` for every call (the megakernel
    is off under TP whatever ``decode_mega`` says)."""

    def __init__(self, params: Dict[str, Any], cfg: QwenConfig, mesh: Mesh, *,
                 reduced_codes_head: bool = True, **knobs):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = mesh.tp
        self.group = mesh.tp_group
        self.params = prepare_tp_params(params, cfg, mesh)
        self.cfg_l = local_cfg(cfg, self.tp)
        self.reduced_codes_head = reduced_codes_head
        self.knobs = knobs
        self._head_red_cache: Dict[Tuple, Any] = {}

    def init_cache(self, batch: int, max_len: int, kv_dtype: str = "int8") -> KVCache:
        return kvc.init_cache(self.cfg.num_hidden_layers, batch, self.cfg_l.num_key_value_heads,
                              max_len, self.cfg.head_dim, kv_dtype, self.mesh.device)

    def head_red(self, sp: SamplingParams):
        """This rank's column shard of the reduced codes head cut from the
        whole head, or None (no allowed range, the switch off, or a tied
        head: the decode loop then runs the full head)."""
        w = (self.params.get("lm_head") or {}).get("kernel")
        if sp.allowed_range is None or not self.reduced_codes_head or w is None:
            return None
        key = (sp.allowed_range, sp.eos_token)
        if key not in self._head_red_cache:
            if isinstance(w, QuantTensor):
                whole = QuantTensor(w.fmt, (w.shape[0], w.shape[1] * self.tp),
                                    **{f: all_gather_cat(a, self.group, dim=-1)
                                       for f, a in w.fields().items()})
            else:
                whole = all_gather_cat(w, self.group, dim=-1)
            red, _, _ = lm_serving._slice_head_cols(whole, sp.allowed_range[0],
                                                    sp.allowed_range[1], sp.eos_token)
            self._head_red_cache[key] = shard_weight(red, "col", self.tp, self.group.index)
        return self._head_red_cache[key]

    def prefill(self, prompt_ids, lengths, cache):
        return lm_serving.prefill(self.params, self.cfg_l, prompt_ids, lengths, cache,
                                  int8_act=self.knobs.get("int8_act", False), group=self.group)

    def extend_prefill(self, cache, new_ids, start, suffix_lengths=None):
        return lm_serving.extend_prefill(self.params, self.cfg_l, cache, new_ids, start,
                                         suffix_lengths,
                                         int8_act=self.knobs.get("int8_act", False),
                                         group=self.group)

    def decode_step(self, cache, token_ids, head=None):
        """One decode step (the host-stepped FSM's)."""
        return lm_serving.decode_step(self.params, self.cfg_l, cache, token_ids, head,
                                      group=self.group, **self.knobs)

    def decode_from_state(self, cache, logits, gen, sp: SamplingParams, ucache=None,
                          ulogits=None, min_tokens_arr=None, forced_eos_arr=None):
        return lm_serving.decode_from_state(
            self.params, self.cfg_l, cache, logits, gen, sp, ucache, ulogits, min_tokens_arr,
            forced_eos_arr, group=self.group, head_red_override=self.head_red(sp),
            **self.knobs)

    def generate(self, prompt_ids, prompt_lengths, gen, sp: SamplingParams,
                 uncond_prompt_ids=None, uncond_prompt_lengths=None, min_tokens_arr=None,
                 forced_eos_arr=None, kv_dtype: str = "int8"):
        return lm_serving.generate(
            self.params, self.cfg_l, prompt_ids, prompt_lengths, gen, sp, uncond_prompt_ids,
            uncond_prompt_lengths, min_tokens_arr, forced_eos_arr, kv_dtype=kv_dtype,
            group=self.group, head_red_override=self.head_red(sp), **self.knobs)
