"""LM planner pipeline: prompts, the two-phase CoT -> codes generation and
output parsing (port of the JAX package's lm_pipeline.py).

  * the prompt builders reproduce the fine-tune chat format byte for byte
    (Qwen chat template with the reference's instruction strings);
  * ``LMPipeline.generate_with_stop_condition`` runs phase 1 (the CoT
    metadata block, stopped at ``</think>``; unconstrained sampling) and
    phase 2 (5 Hz audio codes, EOS blocked until duration x 5 codes and forced
    right after), with the shared prompt prefill reused through the prefix
    cache, code-count buckets, batch candidates and classifier-free guidance;
  * ``parse_lm_output`` parses the CoT block (multi-line values, int bpm and
    duration).

``constrained_cot=True`` runs phase 1 under the metadata FSM
(constrained.py): by default its compiled DFA decodes on the device
(serving.lm.generate_with_fsm_device); ``device_fsm=False``, or a DFA that
exceeds its budget, takes the host-stepped FSM instead.  The LM-only flows
(understanding, inspiration, rewrite) share the single-prompt generation.

Tokenization is pluggable: any object with ``encode`` / ``decode`` and the
special-token ids (``TokenizerLike``); ``TokenizerJsonAdapter`` reads a
checkpoint's tokenizer.json (it needs the ``tokenizers`` package) and
``HFTokenizerAdapter`` wraps a HuggingFace tokenizer.  The pipeline runs on
the card unless it is given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import re
import time
import warnings
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from acestep_tpu_torch import constrained
from acestep_tpu_torch.config import QwenConfig
from acestep_tpu_torch.constants import (
    AUDIO_CODEBOOK_SIZE,
    DEFAULT_LM_INSPIRED_INSTRUCTION,
    DEFAULT_LM_INSTRUCTION,
    DEFAULT_LM_REWRITE_INSTRUCTION,
    DEFAULT_LM_UNDERSTAND_INSTRUCTION,
    DEFAULT_NEGATIVE_PROMPT,
    LM_CODE_RATE,
)
from acestep_tpu_torch.models import qwen
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.pipeline import fold_seed, resolve_device
from acestep_tpu_torch.serving import kv_cache as kvc
from acestep_tpu_torch.serving import lm as lm_serving
from acestep_tpu_torch.serving.lm import SamplingParams
from acestep_tpu_torch.weights import tree_to

CODE_PATTERN = re.compile(r"<\|audio_code_(\d+)\|>")

METADATA_KEYS = ("bpm", "caption", "duration", "genres", "keyscale", "language", "timesignature")


class TokenizerLike(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...

    eos_token_id: int
    think_end_id: int            # token id of "</think>"
    audio_code_base_id: int      # id of <|audio_code_0|>; codes are contiguous


@dataclasses.dataclass
class TokenizerJsonAdapter:
    """Wraps a raw tokenizer.json through the ``tokenizers`` package (imported
    when the adapter is made; checkpoints ship tokenizer.json)."""

    path: str
    eos_token: str = "<|im_end|>"

    def __post_init__(self):
        from tokenizers import Tokenizer

        self.tok = Tokenizer.from_file(self.path)
        self.eos_token_id = self.tok.token_to_id(self.eos_token)
        if self.eos_token_id is None:
            self.eos_token_id = self.tok.token_to_id("<|endoftext|>") or 0
        ids = self.tok.encode("</think>", add_special_tokens=False).ids
        self.think_end_id = ids[-1] if len(ids) == 1 else -1
        base = self.tok.token_to_id("<|audio_code_0|>")
        self.audio_code_base_id = base if base is not None else -1

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=False)


@dataclasses.dataclass
class HFTokenizerAdapter:
    """Wraps a HuggingFace tokenizer (from the LM checkpoint)."""

    tok: Any
    eos_token_id: int = -1
    think_end_id: int = -1
    audio_code_base_id: int = -1

    def __post_init__(self):
        if self.eos_token_id < 0:
            self.eos_token_id = self.tok.eos_token_id
        if self.think_end_id < 0:
            ids = self.tok.encode("</think>", add_special_tokens=False)
            self.think_end_id = ids[-1] if len(ids) == 1 else -1
        if self.audio_code_base_id < 0:
            self.audio_code_base_id = self.tok.convert_tokens_to_ids("<|audio_code_0|>")

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids))


# ---------------------------------------------------------------------------
# chat template and prompts
# ---------------------------------------------------------------------------

def apply_chat_template(messages: Sequence[Dict[str, str]],
                        add_generation_prompt: bool = True) -> str:
    parts = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in messages]
    if add_generation_prompt:
        parts.append("<|im_start|>assistant\n")
    out = "".join(parts)
    if not add_generation_prompt and out.endswith("<|im_end|>\n"):
        # the codes phase continues INSIDE the assistant turn after the CoT
        out = out[: -len("<|im_end|>\n")]
    return out


def _has_meaningful_negative(negative_prompt: str) -> bool:
    return bool(negative_prompt) and negative_prompt.strip() not in ("", DEFAULT_NEGATIVE_PROMPT)


def _system_message() -> Dict[str, str]:
    return {"role": "system", "content": f"# Instruction\n{DEFAULT_LM_INSTRUCTION}\n\n"}


def build_formatted_prompt(caption: str, lyrics: str = "", is_negative_prompt: bool = False,
                           generation_phase: str = "cot",
                           negative_prompt: str = DEFAULT_NEGATIVE_PROMPT) -> str:
    """Phase-1 (CoT) prompt."""
    if is_negative_prompt:
        if generation_phase == "cot":
            if _has_meaningful_negative(negative_prompt):
                prompt = f"# Caption\n{negative_prompt}\n\n# Lyric\n{lyrics}\n"
            else:
                prompt = f"# Lyric\n{lyrics}\n"
        else:
            prompt = caption
    else:
        prompt = f"# Caption\n{caption}\n\n# Lyric\n{lyrics}\n"
    return apply_chat_template([_system_message(), {"role": "user", "content": prompt}],
                               add_generation_prompt=True)


def build_formatted_prompt_with_cot(caption: str, lyrics: str, cot_text: str,
                                    is_negative_prompt: bool = False,
                                    negative_prompt: str = DEFAULT_NEGATIVE_PROMPT) -> str:
    """Phase-2 (codes) prompt with the CoT in the open assistant turn."""
    if is_negative_prompt:
        cot_for_prompt = "<think>\n</think>"
        caption_for_prompt = (negative_prompt if _has_meaningful_negative(negative_prompt)
                              else caption)
    else:
        cot_for_prompt = cot_text
        caption_for_prompt = caption
    user_prompt = f"# Caption\n{caption_for_prompt}\n\n# Lyric\n{lyrics}\n"
    formatted = apply_chat_template(
        [_system_message(), {"role": "user", "content": user_prompt},
         {"role": "assistant", "content": cot_for_prompt}],
        add_generation_prompt=False)
    if not formatted.endswith("\n"):
        formatted += "\n"
    return formatted


def build_understanding_prompt(audio_codes: str, is_negative_prompt: bool = False,
                               negative_prompt: str = DEFAULT_NEGATIVE_PROMPT) -> str:
    """Understanding prompt: audio codes -> metadata and lyrics."""
    user_content = ((negative_prompt if negative_prompt and negative_prompt.strip() else "")
                    if is_negative_prompt else audio_codes)
    return apply_chat_template(
        [{"role": "system", "content": f"# Instruction\n{DEFAULT_LM_UNDERSTAND_INSTRUCTION}\n\n"},
         {"role": "user", "content": user_content}],
        add_generation_prompt=True)


def build_sample_prompt(query: str, instruction: str = DEFAULT_LM_INSPIRED_INSTRUCTION) -> str:
    """Inspiration (and, with the rewrite instruction, rewrite) prompt."""
    return apply_chat_template(
        [{"role": "system", "content": f"# Instruction\n{instruction}\n\n"},
         {"role": "user", "content": query}],
        add_generation_prompt=True)


# ---------------------------------------------------------------------------
# output parsing
# ---------------------------------------------------------------------------

def postprocess_caption(value: str) -> str:
    """Collapse multi-line caption values into one line."""
    lines = [ln.strip() for ln in value.split("\n")]
    return " ".join(ln for ln in lines if ln).strip()


def parse_lm_output(output_text: str) -> Tuple[Dict[str, Any], str]:
    """(metadata, audio_codes string) of an LM completion."""
    metadata: Dict[str, Any] = {}
    audio_codes = "".join(f"<|audio_code_{m}|>" for m in CODE_PATTERN.findall(output_text))

    reasoning_text = None
    for pattern in (r"<think>(.*?)</think>", r"<reasoning>(.*?)</reasoning>"):
        m = re.search(pattern, output_text, re.DOTALL)
        if m:
            reasoning_text = m.group(1).strip()
            break
    if reasoning_text is None:
        before = (output_text.split("<|audio_code_")[0] if "<|audio_code_" in output_text
                  else output_text)
        reasoning_text = before.strip()

    current_key: Optional[str] = None
    current_lines: List[str] = []

    def save():
        nonlocal current_key, current_lines
        if current_key and current_lines:
            value = "\n".join(current_lines)
            if current_key in ("bpm", "duration"):
                try:
                    metadata[current_key] = int(value.strip())
                except ValueError:
                    metadata[current_key] = value.strip()
            elif current_key == "caption":
                metadata["caption"] = postprocess_caption(value)
            elif current_key in METADATA_KEYS:
                metadata[current_key] = value.strip()
        current_key = None
        current_lines = []

    for line in reasoning_text.split("\n"):
        if line.strip().startswith("<"):
            continue
        if line and not line[0].isspace() and ":" in line:
            save()
            key, _, first = line.partition(":")
            current_key = key.strip().lower()
            if first.strip():
                current_lines.append(first)
        elif line.startswith((" ", "\t")) and current_key:
            current_lines.append(line)
    save()
    return metadata, audio_codes


def codes_to_indices(audio_codes: str) -> np.ndarray:
    return np.asarray([int(m) for m in CODE_PATTERN.findall(audio_codes)], np.int32)


def indices_to_codes(indices: Sequence[int]) -> str:
    return "".join(f"<|audio_code_{int(i)}|>" for i in indices)


def metadata_to_cot(metadata: Dict[str, Any]) -> str:
    """A metadata dict as the canonical CoT block."""
    lines = [f"{k}: {metadata[k]}" for k in METADATA_KEYS if k in metadata]
    return "<think>\n" + "\n".join(lines) + "\n</think>"


# ---------------------------------------------------------------------------
# two-phase pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LMResult:
    metadata: Dict[str, Any]
    cot_text: str
    audio_codes: str
    code_indices: np.ndarray
    time_costs: Dict[str, float]
    # batch candidate code sequences; [0] == code_indices
    candidates: Optional[List[np.ndarray]] = None
    # after a constrained CoT: the machine that ran it ("device_dfa" or
    # "host_fsm") and its token ids
    cot_route: Optional[str] = None
    cot_ids: Optional[List[int]] = None


# code-count buckets (10-600 s -> 50-3000 codes); the forced-EOS count is a
# per-row operand, so every duration in a bucket runs the same decode shapes
CODE_BUCKETS = (64, 128, 256, 512, 768, 1024, 1536, 2048, 2560, 3072)
# suffix buckets of the prefix-cache extend path
SUFFIX_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)


def code_bucket(n: int) -> int:
    for b in CODE_BUCKETS:
        if n <= b:
            return b
    return CODE_BUCKETS[-1]


def _suffix_bucket(n: int) -> int:
    for b in SUFFIX_BUCKETS:
        if n <= b:
            return b
    return SUFFIX_BUCKETS[-1]


def _seeded_generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent torch.Generator on ``device`` for stream ``stream`` of
    ``seed``."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, stream))


class LMPipeline:
    """Owns the LM params and tokenizer and runs the two-phase generation.

    Serving features: batch candidates in the codes phase (``batch_size``,
    chunked by ``chunk_size``); a KV prefix cache (the phase-1 system+user
    prompt prefill is reused by phase 2: grown, suffix-prefilled and broadcast
    to the batch); code-count buckets with per-row forced EOS.

    The JAX package's environment knobs are keyword arguments with the same
    defaults: ``lm_head_quant`` (ACESTEP_TPU_LM_HEAD_QUANT), ``lm_fuse``
    (_LM_FUSE), ``kv_dtype`` (_KV_DTYPE), ``decode_mega`` (_DECODE_MEGA),
    ``decode_attn`` (_DECODE_ATTN), ``int8_act`` (_INT8_ACT),
    ``reduced_codes_head`` (_REDUCED_CODES_HEAD), ``device_fsm``
    (_DEVICE_FSM) and ``genres_file`` (_GENRES_FILE).  Quant scales are cast
    to f32 once whatever ``lm_fuse`` says: the CUDA matmul kernels read f32
    scales."""

    def __init__(self, params: Dict[str, Any], cfg: QwenConfig, tokenizer: TokenizerLike,
                 *, device=None, lm_head_quant: Optional[str] = "q8_0", lm_fuse: bool = True,
                 kv_dtype: str = "int8", decode_mega: str = "auto",
                 decode_attn: str = "auto", int8_act: bool = False,
                 reduced_codes_head: bool = True, device_fsm: bool = True,
                 genres_file: Optional[str] = None, mesh=None):
        self.device = resolve_device(device, mesh)
        params = tree_to(params, self.device)
        if isinstance(params.get("layers"), list):
            params = qwen.stack_params(params)
        params = lm_serving.ensure_quantized_head(params, lm_head_quant)
        # tensor parallelism (lm_pipeline.py:355-375): rank-major fused, sharded
        # params and the rank's config and group for every serving call
        self.tp_ctx = None
        self.run_cfg, self._tp = cfg, {}
        if mesh is not None:
            from acestep_tpu_torch.parallel.lm_tp import LMTPContext

            self.tp_ctx = LMTPContext(params, cfg, mesh, reduced_codes_head=reduced_codes_head,
                                      decode_attn=decode_attn, int8_act=int8_act)
            params = self.tp_ctx.params
            self.run_cfg, self._tp = self.tp_ctx.cfg_l, {"group": self.tp_ctx.group}
        elif lm_fuse:
            params = lm_serving.fuse_serving_params(params)
        self.params = precast_quant_scales(params)
        self.cfg = cfg
        self.tok = tokenizer
        self.prefix_cache = lm_serving.PrefixCache(max_entries=8)
        self.kv_dtype = kvc.check_kv_dtype(kv_dtype)
        lm_serving.check_knobs(decode_mega, decode_attn, int8_act)
        self.knobs = dict(decode_mega=decode_mega, decode_attn=decode_attn, int8_act=int8_act,
                          reduced_codes_head=reduced_codes_head)
        self.device_fsm = device_fsm
        self.genres_file = genres_file
        self._dfa_cache: Dict[tuple, Tuple[Any, float]] = {}
        self._vocab_strs: Optional[List[str]] = None

    def _ids(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    def _i32(self, vals) -> torch.Tensor:
        return torch.tensor(vals, dtype=torch.int32, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _bucket(ids):
        """Pad a token list to a length bucket (one set of prefill shapes per
        bucket instead of one per prompt length)."""
        for b in PROMPT_BUCKETS:
            if len(ids) <= b:
                return ids + [0] * (b - len(ids))
        return ids[:PROMPT_BUCKETS[-1]]

    def _run(self, prompt: str, sp: SamplingParams, gen: torch.Generator,
             uncond_prompt: Optional[str] = None) -> Tuple[np.ndarray, int]:
        """One batch-1 generation from a prompt string (no prefix cache)."""
        ids = self.tok.encode(prompt)
        ukw = {}
        if uncond_prompt is not None and sp.cfg_scale != 1.0:
            uids = self.tok.encode(uncond_prompt)
            ukw = dict(uncond_prompt_ids=self._ids([self._bucket(uids)]),
                       uncond_prompt_lengths=self._i32([min(len(uids), 4096)]))
        tokens, n_gen = lm_serving.generate(
            self.params, self.run_cfg, self._ids([self._bucket(ids)]),
            self._i32([min(len(ids), 4096)]), gen, sp, kv_dtype=self.kv_dtype, **ukw,
            **self.knobs, **self._tp_kw(sp))
        n = int(n_gen[0])
        return tokens[0, :n].cpu().numpy(), n

    def _prefill_state(self, ids, total_len: int, insert: bool = False):
        """Batch-1 prefill of ``ids`` into a cache with room for ``total_len``
        positions, reusing the longest cached token prefix.  Returns (cache,
        logits [1, V]); the cache may be a prefix-cache entry (read-only)."""
        ids = list(ids)[:4096]
        total_len = kvc.round_len(total_len)
        hit = self.prefix_cache.lookup(ids)
        if hit is not None:
            n0, cache0, logits0 = hit
            cache = kvc.grow_cache(cache0, total_len)
            if n0 == len(ids):
                return cache, logits0
            rest = ids[n0:]
            bucket = _suffix_bucket(len(rest))
            logits, cache = lm_serving.extend_prefill(
                self.params, self.run_cfg, cache,
                self._ids([rest + [0] * (bucket - len(rest))]), self._i32([n0]),
                self._i32([len(rest)]), int8_act=self.knobs["int8_act"], **self._tp)
        else:
            prompt_ids = self._ids([self._bucket(ids)])
            total_len = kvc.round_len(max(total_len, prompt_ids.shape[1] + 1))
            cache = kvc.init_cache(self.cfg.num_hidden_layers, 1,
                                   self.run_cfg.num_key_value_heads, total_len,
                                   self.cfg.head_dim, self.kv_dtype, self.device)
            logits, cache = lm_serving.prefill(self.params, self.run_cfg, prompt_ids,
                                               self._i32([len(ids)]), cache,
                                               int8_act=self.knobs["int8_act"], **self._tp)
        if insert:
            self.prefix_cache.insert(ids, cache, logits)
        return cache, logits

    def _decode_batch(self, cache, logits, sp: SamplingParams, gen, batch: int,
                      min_arr=None, forced_arr=None, ucache=None, ulogits=None):
        """Broadcast a batch-1 prefill state to ``batch`` candidate rows and
        run the decode loop; returns (tokens [B, max_new], n_gen [B]) numpy."""
        ukw = {}
        if ucache is not None:
            ukw = dict(ucache=kvc.broadcast_cache(ucache, batch),
                       ulogits=ulogits.expand(batch, -1))
        tokens, n_gen = lm_serving.decode_from_state(
            self.params, self.run_cfg, kvc.broadcast_cache(cache, batch),
            logits.expand(batch, -1), gen, sp, min_tokens_arr=min_arr,
            forced_eos_arr=forced_arr, **ukw, **self.knobs, **self._tp_kw(sp))
        return tokens.cpu().numpy(), n_gen.cpu().numpy()

    def _tp_kw(self, sp: SamplingParams) -> Dict[str, Any]:
        """The decode loop's tensor-parallel keywords: the group and this
        rank's shard of the reduced codes head ({} unmeshed)."""
        if self.tp_ctx is None:
            return {}
        return dict(self._tp, head_red_override=self.tp_ctx.head_red(sp))

    @torch.no_grad()
    def generate_with_stop_condition(
        self, caption: str, lyrics: str = "", target_duration_s: Optional[float] = None, *,
        temperature: float = 0.85, metadata_temperature: Optional[float] = None,
        codes_temperature: Optional[float] = None, top_p: float = 0.95, top_k: int = 0,
        cfg_scale: float = 1.0, negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
        max_cot_tokens: int = 512, max_code_tokens: Optional[int] = None,
        user_metadata: Optional[Dict[str, Any]] = None, seed: int = 0, thinking: bool = True,
        batch_size: int = 1, chunk_size: int = 4, constrained_cot: bool = False,
    ) -> LMResult:
        """Phase 1 CoT -> parse metadata -> phase 2 duration-constrained codes.

        ``batch_size`` > 1 draws that many candidate code sequences from the
        shared CoT (chunked by ``chunk_size``); the first fills the result, all
        are in ``candidates``.  ``constrained_cot`` runs phase 1 under the
        metadata FSM, with the user's metadata forced.  ``time_costs`` adds to
        the JAX package's two phase keys the phase-2 prefill and decode split."""
        time_costs: Dict[str, float] = {}
        g1 = _seeded_generator(seed, 1, self.device)
        g2 = _seeded_generator(seed, 2, self.device)
        t_meta = temperature if metadata_temperature is None else metadata_temperature
        t_codes = temperature if codes_temperature is None else codes_temperature

        metadata: Dict[str, Any] = dict(user_metadata or {})
        cot_route = cot_ids = None
        if thinking:
            t0 = time.perf_counter()
            if constrained_cot:
                cot_text, cot_route, cot_ids = self._run_cot_fsm(caption, lyrics, metadata, g1, temperature=t_meta,
                                             max_cot_tokens=max_cot_tokens)
            else:
                cot_text = self._run_cot_free(caption, lyrics, g1, temperature=t_meta,
                                              top_p=top_p, top_k=top_k, cfg_scale=cfg_scale,
                                              negative_prompt=negative_prompt,
                                              max_cot_tokens=max_cot_tokens)
            parsed, _ = parse_lm_output(cot_text)
            for k, v in parsed.items():          # user metadata wins over the CoT
                metadata.setdefault(k, v)
            time_costs["lm_phase1_time_cost"] = time.perf_counter() - t0
        else:
            cot_text = metadata_to_cot(metadata) if metadata else "<think>\n</think>"

        duration = target_duration_s or metadata.get("duration") or 30.0
        try:
            duration = float(duration)
        except (TypeError, ValueError):
            duration = 30.0
        n_codes = int(round(duration * LM_CODE_RATE))
        if max_code_tokens is not None:
            n_codes = min(n_codes, max_code_tokens)

        t0 = time.perf_counter()
        prompt2 = build_formatted_prompt_with_cot(caption, lyrics,
                                                  cot_text or metadata_to_cot(metadata))
        base = self.tok.audio_code_base_id
        bucket = code_bucket(n_codes + 2)
        sp2 = SamplingParams(temperature=t_codes, top_p=top_p, top_k=top_k,
                             max_new_tokens=bucket,
                             allowed_range=(base, base + AUDIO_CODEBOOK_SIZE),
                             eos_token=self.tok.eos_token_id, cfg_scale=cfg_scale)
        ids2 = self.tok.encode(prompt2)
        cache, logits = self._prefill_state(ids2, len(self._bucket(ids2)) + bucket + 1)
        ucache = ulogits = None
        if cfg_scale != 1.0:
            uncond2 = build_formatted_prompt_with_cot(caption, lyrics, "",
                                                      is_negative_prompt=True,
                                                      negative_prompt=negative_prompt)
            uids = self.tok.encode(uncond2)
            ucache, ulogits = self._prefill_state(uids, len(self._bucket(uids)) + bucket + 1)
        self._sync()
        t_prefill = time.perf_counter()

        candidates: List[np.ndarray] = []
        remaining = max(1, batch_size)
        while remaining > 0:
            nb = min(remaining, max(1, chunk_size))
            rows = self._i32([n_codes] * nb)
            toks, n_gen = self._decode_batch(cache, logits, sp2, g2, nb, min_arr=rows,
                                             forced_arr=rows, ucache=ucache, ulogits=ulogits)
            for i in range(nb):
                row = toks[i, : int(n_gen[i])]
                codes = row[(row >= base) & (row < base + AUDIO_CODEBOOK_SIZE)] - base
                candidates.append(codes.astype(np.int32))
            remaining -= nb
        code_ids = candidates[0]
        t_end = time.perf_counter()
        time_costs["lm_phase2_time_cost"] = t_end - t0
        time_costs["lm_phase2_prefill_time_cost"] = t_prefill - t0
        time_costs["lm_phase2_decode_time_cost"] = t_end - t_prefill
        return LMResult(metadata=metadata, cot_text=cot_text,
                        audio_codes=indices_to_codes(code_ids), code_indices=code_ids,
                        time_costs=time_costs, candidates=candidates, cot_route=cot_route,
                        cot_ids=cot_ids)

    def _run_cot_free(self, caption, lyrics, gen, *, temperature, top_p, top_k, cfg_scale,
                      negative_prompt, max_cot_tokens) -> str:
        """Unconstrained CoT sampling from the prefix-cached prompt prefill."""
        ids = self.tok.encode(build_formatted_prompt(caption, lyrics, generation_phase="cot"))
        sp = SamplingParams(temperature=temperature, top_p=top_p, top_k=top_k,
                            max_new_tokens=max_cot_tokens,
                            stop_tokens=(self.tok.think_end_id,), cfg_scale=cfg_scale)
        cache, logits = self._prefill_state(ids, len(self._bucket(ids)) + max_cot_tokens + 1,
                                            insert=True)
        ucache = ulogits = None
        if cfg_scale != 1.0:
            uids = self.tok.encode(build_formatted_prompt(
                caption, lyrics, is_negative_prompt=True, generation_phase="cot",
                negative_prompt=negative_prompt))
            ucache, ulogits = self._prefill_state(
                uids, len(self._bucket(uids)) + max_cot_tokens + 1)
        toks, n_gen = self._decode_batch(cache, logits, sp, gen, 1, ucache=ucache,
                                         ulogits=ulogits)
        row = [int(t) for t in toks[0, : int(n_gen[0])] if t >= 0]
        cot_body = self.tok.decode([t for t in row if t != self.tok.think_end_id])
        cot_text = f"<think>\n{cot_body}".rstrip()
        if not cot_text.endswith("</think>"):
            cot_text += "\n</think>"
        return cot_text

    def _run_cot_fsm(self, caption, lyrics, user_metadata, gen, *, temperature,
                     max_cot_tokens) -> Tuple[str, str, List[int]]:
        """FSM-constrained CoT: field order and value grammars enforced during
        generation, user metadata injected as forced text.  The compiled DFA
        on the device by default (its own prefill; nothing enters the prefix
        cache), the host-stepped FSM with ``device_fsm=False`` or when the DFA
        exceeds its budget.  Returns (CoT text, the machine that ran it, its
        token ids)."""
        ids = self.tok.encode(build_formatted_prompt(caption, lyrics, generation_phase="cot"))
        vocab_strs = self.vocab_strs()
        knobs = dict(kv_dtype=self.kv_dtype, decode_mega=self.knobs["decode_mega"],
                     decode_attn=self.knobs["decode_attn"], int8_act=self.knobs["int8_act"])
        # under TP the host FSM runs against the TP prefill and decode step
        # (the JAX package's rule, lm_pipeline.py:681)
        dfa = (self.compiled_dfa(user_metadata)[0]
               if self.device_fsm and self.tp_ctx is None else None)
        if dfa is not None:
            cot_ids, text = lm_serving.generate_with_fsm_device(
                self.params, self.cfg, ids, dfa, vocab_strs, gen, temperature=temperature,
                max_new_tokens=max_cot_tokens, **knobs)
            route = "device_dfa"
        else:
            fsm = constrained.MetadataFSM(self._fsm_config(), user_metadata=user_metadata or {})
            cot_ids, text = lm_serving.generate_with_fsm(
                self.params, self.run_cfg, ids, fsm, vocab_strs, gen, temperature=temperature,
                max_new_tokens=max_cot_tokens, **knobs, **self._tp)
            route = "host_fsm"
        return f"<think>\n{text.strip()}\n</think>", route, cot_ids

    def _fsm_config(self) -> constrained.FSMConfig:
        return constrained.FSMConfig(genres_vocab=constrained.load_genres_vocab(self.genres_file))

    def compiled_dfa(self, user_metadata: Optional[Dict[str, Any]] = None):
        """(``compile_dfa`` of this pipeline's vocab and genres under
        ``user_metadata``, the seconds its compile took), cached by (vocab,
        genres content, user metadata).  The DFA is None (with a warning) when
        the machine exceeds its budget: the caller then takes the host FSM, as
        the JAX package does."""
        vocab_strs = self.vocab_strs()
        fsm_cfg = self._fsm_config()
        key = (id(vocab_strs), len(vocab_strs), hash(tuple(fsm_cfg.genres_vocab)),
               tuple(sorted((k, str(v)) for k, v in (user_metadata or {}).items())))
        if key in self._dfa_cache:
            return self._dfa_cache[key]
        t0 = time.perf_counter()
        try:
            dfa = constrained.compile_dfa(vocab_strs, fsm_cfg, user_metadata=user_metadata or {})
        except constrained.DFACompileError as e:
            warnings.warn(f"device FSM unavailable ({e}); using host FSM", stacklevel=2)
            dfa = None
        if len(self._dfa_cache) > 16:
            self._dfa_cache.clear()
        self._dfa_cache[key] = (dfa, time.perf_counter() - t0)
        return self._dfa_cache[key]

    def vocab_strs(self) -> List[str]:
        """Token id -> string piece for the whole vocab (FSM masking): the
        tokenizer's own ``vocab_strs()`` where it has one."""
        if self._vocab_strs is None:
            tok = self.tok
            if hasattr(tok, "vocab_strs"):
                self._vocab_strs = tok.vocab_strs()
            else:
                self._vocab_strs = [tok.decode([i]) for i in range(self.cfg.vocab_size)]
        return self._vocab_strs

    # -- LM-only flows -------------------------------------------------------

    def _flow(self, prompt: str, *, temperature: float, top_p: float, max_tokens: int,
              seed: int) -> Dict[str, Any]:
        sp = SamplingParams(temperature=temperature, top_p=top_p, max_new_tokens=max_tokens,
                            stop_tokens=(self.tok.eos_token_id,))
        toks, _ = self._run(prompt, sp, _seeded_generator(seed, 0, self.device))
        text = self.tok.decode(toks)
        metadata, _ = parse_lm_output(text)
        metadata["raw_output"] = text
        return metadata

    @torch.no_grad()
    def understand_audio_from_codes(self, audio_codes: str, *, temperature: float = 0.7,
                                    top_p: float = 0.95, max_tokens: int = 1024,
                                    seed: int = 0) -> Dict[str, Any]:
        """Understanding flow: audio codes -> metadata and lyrics."""
        return self._flow(build_understanding_prompt(audio_codes), temperature=temperature,
                          top_p=top_p, max_tokens=max_tokens, seed=seed)

    @torch.no_grad()
    def create_sample_from_query(self, query: str, *, temperature: float = 0.85,
                                 top_p: float = 0.95, max_tokens: int = 768,
                                 seed: int = 0) -> Dict[str, Any]:
        """Inspiration flow: a free-text query -> a structured sample."""
        return self._flow(build_sample_prompt(query, DEFAULT_LM_INSPIRED_INSTRUCTION),
                          temperature=temperature, top_p=top_p, max_tokens=max_tokens,
                          seed=seed)

    @torch.no_grad()
    def format_sample_from_input(self, text: str, *, temperature: float = 0.3,
                                 top_p: float = 0.9, max_tokens: int = 768,
                                 seed: int = 0) -> Dict[str, Any]:
        """Rewrite flow: messy input -> a formatted sample."""
        return self._flow(build_sample_prompt(text, DEFAULT_LM_REWRITE_INSTRUCTION),
                          temperature=temperature, top_p=top_p, max_tokens=max_tokens,
                          seed=seed)
