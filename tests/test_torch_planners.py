"""The larger LM planners (Qwen3-1.7B and 4B fine-tunes) in the port, on the CPU.

  * Row 6's launch plan (``ops/cuda/qmm_int8.int8_plan``) has a plan whose
    shared memory fits for every linear of the 0.6B, 1.7B and 4B planners and
    the reduced codes head at M 1-16 (the 4B's down_proj, K 9728, at M 10-16
    and its o_proj at M 16 had none), and for any K that is a multiple of 32
    up to 16384.
  * A small planner with the 4B's proportions (4 layers, hidden 256, 8 / 2
    heads of 128, so q is 4x hidden; intermediate 1024), tied and untied:
    one set of reference-named files is converted by both packages'
    converters (``--lm --lm-quant q8_0``) and built by both packages'
    ``build_lm`` with one WordLevel tokenizer.json.  The first logits agree
    within tests/test_torch_lm_serving.py's bound for a q8_0 model with bf16
    activations (2e-2 of the peak) and greedy ``generate_with_stop_condition``
    gives the same codes (AUDIO_CODEBOOK_SIZE patched to 500 in both, as
    tests/test_torch_lm_pipeline.py does).  Then with int8_act, a prefix-cache
    hit whose 12-token suffix is prefilled in the 16-token bucket: every
    linear at M 16 through row 6's plain version, each within one bf16 step
    of the JAX ``qmm_int8_act`` (Pallas interpret mode) on the same inputs
    with at least 99% of the outputs equal (tests/test_torch_qmm_int8.py's
    bound: both sum the same exact f32 terms in K order), and the logits
    within that file's 4e-2 of the peak.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

import acestep_tpu.ops.pallas.qmm as jqmm
from acestep_tpu import loader as jloader
from acestep_tpu import lm_pipeline as jlp
from acestep_tpu.serving import launch as jlaunch
from acestep_tpu.serving import lm as jlm
from acestep_tpu_torch import lm_pipeline as tlp
from acestep_tpu_torch import loader as tloader
from acestep_tpu_torch.config import QWEN3_0_6B, QWEN3_1_7B, QWEN3_4B
from acestep_tpu_torch.ops.cuda import qmm_int8 as tint8
from acestep_tpu_torch.serving import launch as tlaunch
from acestep_tpu_torch.serving import lm as tlm
from tests.test_torch_converter import jax_convert, port_convert, qwen_tensors, write_checkpoint
from tests.test_torch_qmm_int8 import EQUAL_MIN, _jax_int8, _one_step
from tests.test_torch_qmm_int8 import pallas_int8  # noqa: F401  (a fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PLANNERS = {"0.6B": QWEN3_0_6B, "1.7B": QWEN3_1_7B, "4B": QWEN3_4B}
CODES_HEAD_N = 65536          # the reduced codes head: 64000 codes + EOS, padded to 2048s
SMALL = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
             num_key_value_heads=2, head_dim=128, intermediate_size=1024)
CODEBOOK = 500
CODE_BASE, EOS_ID = 500, 1000
BF16_REL = 2e-2               # tests/test_torch_lm_serving.py, the q8_0 model
LOGIT_REL_INT8 = 4e-2         # tests/test_torch_qmm_int8.py
CAPTION, LYRICS = "warm night synth drive", "[verse]\nneon rain city\n[chorus]\nslow glow"
SUFFIX = 12                   # tokens past the cached prefix: the 16-token bucket


def planner_linears(cfg):
    """(K, N) of a planner's q8_0 linears as the fused serving tree holds them:
    qkv, o_proj, gate-up, down_proj and the reduced codes head."""
    h, qd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    return [(h, qd + 2 * kvd), (qd, h), (h, 2 * cfg.intermediate_size),
            (cfg.intermediate_size, h), (h, CODES_HEAD_N)]


def _plan_ok(m, k, n):
    bn, splits = tint8.int8_plan(m, k, n)
    nkb = k // 32
    per = -(-nkb // splits)
    assert bn in tint8.TILES_N and n % bn == 0 and bn // splits >= 4
    assert math.ceil(nkb / per) == splits                  # whole, non-empty runs
    assert tint8.int8_smem(m, k, bn, splits) <= tint8.SMEM_MAX, (m, k, n, bn, splits)
    return bn, splits


@pytest.mark.parametrize("planner", sorted(PLANNERS))
def test_int8_plan_fits_every_planner_linear(planner):
    """Every linear at every M of 1-16 has a plan that fits and fills the card
    (at least one block per SM)."""
    for k, n in planner_linears(PLANNERS[planner]):
        for m in range(1, tint8.MAX_M + 1):
            bn, splits = _plan_ok(m, k, n)
            assert n // bn * splits >= tint8.SMS, (planner, m, k, n, bn, splits)


@pytest.mark.parametrize("k", [32, 96, 4000, 9728, 16384])
def test_int8_plan_fits_any_k(k):
    for m in range(1, tint8.MAX_M + 1):
        for n in (128, 2560, CODES_HEAD_N):
            _plan_ok(m, k, n)


# ---------------------------------------------------------------------------
# a small planner with the 4B's proportions, through both packages
# ---------------------------------------------------------------------------

def _write_tokenizer(path):
    """A WordLevel tokenizer.json: the prompt's words, the 500 codes from id
    500, <|im_end|> at 1000, </think> and <|im_end|> tokenizing whole."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = sorted(set((tlp.build_formatted_prompt(CAPTION, LYRICS) + " "
                        + tlp.metadata_to_cot({"bpm": 100})).split()) - {"</think>", "<|im_end|>"})
    pieces = ["[UNK]", "</think>"] + words
    pieces += [f"x{i}" for i in range(CODE_BASE - len(pieces))]
    pieces += [f"<|audio_code_{j}|>" for j in range(CODEBOOK)] + ["<|im_end|>"]
    pieces += [f"y{i}" for i in range(SMALL["vocab_size"] - len(pieces))]
    assert pieces[EOS_ID] == "<|im_end|>" and len(set(pieces)) == SMALL["vocab_size"]
    tok = Tokenizer(models.WordLevel({p: i for i, p in enumerate(pieces)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["</think>", "<|im_end|>"])
    tok.save(path)


@pytest.fixture(scope="module", params=["tied", "untied"])
def planners(request, tmp_path_factory):
    """(JAX pipeline, port pipeline, the JAX pipeline on its layer list) of
    one converted small planner."""
    root = tmp_path_factory.mktemp(f"planner_{request.param}")
    cfg = dict(SMALL, tie_word_embeddings=request.param == "tied")
    src = write_checkpoint(str(root / "reference"), qwen_tensors(
        np.random.default_rng(23), cfg, lm_head=request.param == "untied"), cfg)
    _write_tokenizer(os.path.join(src, "tokenizer.json"))
    jax_convert(str(root / "jax"), "q4_k", lm=src, lm_quant="q8_0")
    shutil.copyfile(os.path.join(src, "tokenizer.json"), str(root / "jax" / "tokenizer.json"))
    assert port_convert(str(root / "port"), "q4_k", lm=src, lm_quant="q8_0") == 0
    with open(root / "jax" / "lm.safetensors", "rb") as a, \
            open(root / "port" / "lm.safetensors", "rb") as b:
        assert a.read() == b.read()
    assert ("lm_head" in tloader.load_params(str(root / "port" / "lm"))) == \
        (request.param == "untied")
    jpipe = jlaunch.build_lm(str(root / "jax"))
    tpipe = tlaunch.build_lm(str(root / "port"), device="cpu")
    assert (tpipe.tok.eos_token_id, tpipe.tok.audio_code_base_id) == (EOS_ID, CODE_BASE)
    # the JAX planner again with its layer list: under the Pallas backend the
    # JAX extend step's scan over stacked layers fails its carry dtype check
    jlist = jlp.LMPipeline(jloader.load_params(str(root / "jax" / "lm")), jpipe.cfg, jpipe.tok,
                           stack_layers=False)
    return jpipe, tpipe, jlist


def _codes_prompt_ids(tok):
    return tok.encode(tlp.build_formatted_prompt_with_cot(
        CAPTION, LYRICS, tlp.metadata_to_cot({"bpm": 100})))


def _rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max())


def test_first_logits_and_greedy_codes_match_jax(planners, monkeypatch):
    jpipe, tpipe, _ = planners
    ids = _codes_prompt_ids(tpipe.tok)
    assert ids == jpipe.tok.encode(tlp.build_formatted_prompt_with_cot(
        CAPTION, LYRICS, tlp.metadata_to_cot({"bpm": 100})))
    _, jl = jpipe._prefill_state(ids, 128)
    _, tl = tpipe._prefill_state(ids, 128)
    assert _rel(tl.float().numpy(), jl) <= BF16_REL
    assert int(tl.argmax()) == int(np.asarray(jl).argmax())
    monkeypatch.setattr(jlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    monkeypatch.setattr(tlp, "AUDIO_CODEBOOK_SIZE", CODEBOOK)
    kw = dict(caption=CAPTION, lyrics=LYRICS, target_duration_s=4.0, thinking=False,
              user_metadata={"bpm": 100}, temperature=0.0, batch_size=2, chunk_size=2)
    ref = jpipe.generate_with_stop_condition(**kw)
    got = tpipe.generate_with_stop_condition(**kw)
    assert len(got.candidates) == len(ref.candidates) == 2
    for g, r in zip(got.candidates, ref.candidates):
        assert len(g) == 20
        np.testing.assert_array_equal(g, np.asarray(r))


def test_int8_prefix_hit_suffix_matches_jax(planners, pallas_int8, monkeypatch):
    """The M 16 suffix of a prefix-cache hit through row 6 in both packages:
    each port int8 matmul at M 16 against the JAX kernel on its inputs."""
    _, tpipe, jpipe = planners
    port8 = tlp.LMPipeline(tpipe.params, tpipe.cfg, tpipe.tok, device="cpu", int8_act=True)
    # the JAX extend step eager, so the int8 switch the fixture sets takes effect
    monkeypatch.setattr(jlm, "extend_prefill_jit", jlm.extend_prefill)
    calls = {"m16": 0}
    real = tint8.qmm_int8_act_plain

    def checked(x, qt):
        y = real(x, qt)
        if x.shape[0] == 16:
            assert _one_step(y.float().numpy(), _jax_int8(x, qt)) >= EQUAL_MIN
            calls["m16"] += 1
        return y

    monkeypatch.setattr(tint8, "qmm_int8_act_plain", checked)
    ids = _codes_prompt_ids(tpipe.tok)
    out = []
    for pipe in (jpipe, port8):
        pipe.prefix_cache = type(pipe.prefix_cache)(max_entries=8)
        pipe._prefill_state(ids[:-SUFFIX], 128, insert=True)
        _, logits = pipe._prefill_state(ids, 128)
        assert pipe.prefix_cache.hits == 1
        out.append(np.asarray(logits.float() if isinstance(logits, torch.Tensor) else logits,
                              np.float32))
    layers = SMALL["num_hidden_layers"]
    assert calls["m16"] == 4 * layers                  # qkv, o_proj, gate-up, down a layer
    assert pallas_int8["int8"] > 0
    assert _rel(out[1], out[0]) <= LOGIT_REL_INT8
    assert int(out[1].argmax()) == int(out[0].argmax())
    # the suffix's bucket is 16 rows: extend_prefill ran at M 16, not the whole prompt
    assert tlm.PrefixCache is type(port8.prefix_cache) and jqmm.INT8_ACT_MAX_M == 16
