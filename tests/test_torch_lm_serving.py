"""Port parity: the LM serving path of acestep_tpu_torch (serving/lm.py) against
the JAX package's serving/lm.py, on the CPU.

Parameters come from the JAX package's ``init_params`` drawn from numpy seeds
(``sampler``) and reach the port through ``weights.from_jax_numpy``.

Tolerances:
  * TINY (test_lm_serving.py:14, f32 weights): logits to 2e-3 absolute.  Both
    sides compute in f32, but the tied head rounds its operands to bf16, so an
    f32 difference in the last digit can move a hidden value by one bf16 step;
    int8 cache entries within 1 (a rounding tie that the two f32 summation
    orders break differently); greedy tokens identical.
  * the 256-wide q8_0 model (bf16 activations): logits within 2% of their peak
    with the same argmax, cache entries within 2 (bf16 rounding at every op,
    which XLA fuses in places where PyTorch rounds each op).
  * fused weights and the reduced head: field for field; the quantized head
    field for field with the reference numpy quantizer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu.config import QwenConfig
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu.quant.formats import quantize_q8_0_np
from acestep_tpu.serving import kv_cache as jkvc
from acestep_tpu.serving import lm as jlm
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import weights
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.serving import kv_cache as tkvc
from acestep_tpu_torch.serving import lm as tlm

TINY = QwenConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
                  head_dim=16)
WIDE = QwenConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
                  head_dim=128)
F32_LOGIT_ATOL = 2e-3
BF16_REL = 2e-2


def tcfg_of(cfg):
    return tcfg.QwenConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _sampler(seed, scale):
    rng = np.random.default_rng(seed)
    return lambda shape: (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """TINY f32 params (layer list) in both packages."""
    p = jqwen.init_params(jax.random.key(0), TINY, dtype=jnp.float32, scale=1.0,
                          sampler=_sampler(0, 0.1))
    return p, weights.from_jax_numpy(p)


@pytest.fixture(scope="module")
def wide():
    """The 256-wide model at q8_0 (bf16 activations), stacked, with a quantized
    head and fused weights, in both packages (converted before fusing)."""
    p = jqwen.init_params(jax.random.key(0), WIDE, dtype=jnp.bfloat16, scale=1.0,
                          sampler=_sampler(1, 0.05))
    pq = jqwen.stack_params(quantize_tree_jax(p, "q8_0"))
    return pq, weights.from_jax_numpy(pq)


def _stack(pair):
    return jqwen.stack_params(pair[0]), {**pair[1], "layers": _tstack(pair[1]["layers"])}


def _tstack(layers):
    from acestep_tpu_torch.models.stacking import stack_layer_params

    return stack_layer_params(layers)


def _caches(cfg, b, t_max):
    return (jkvc.init_cache(cfg.num_hidden_layers, b, cfg.num_key_value_heads, t_max,
                            cfg.head_dim),
            tkvc.init_cache(cfg.num_hidden_layers, b, cfg.num_key_value_heads, t_max,
                            cfg.head_dim))


def _close_cache(jc, tc, max_int_diff):
    for f in ("k", "v"):
        d = np.abs(getattr(tc, f).numpy().astype(np.int32)
                   - np.asarray(getattr(jc, f)).astype(np.int32))
        assert d.max() <= max_int_diff, (f, d.max())
    for f in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=2e-2, atol=1e-6)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _prompt(seed, b, t, vocab, lengths):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)
    return ids, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# prefill, extend_prefill, decode_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_prefilled(tiny):
    jp, tp = _stack(tiny)
    ids, lens = _prompt(3, 2, 12, TINY.vocab_size, [12, 9])
    jc, tc = _caches(TINY, 2, 128)
    jl, jc = jlm.prefill(jp, TINY, jnp.asarray(ids), jnp.asarray(lens), jc)
    tl, tc = tlm.prefill(tp, tcfg_of(TINY), torch.from_numpy(ids).long(),
                         torch.from_numpy(lens), tc)
    return jp, tp, jl, jc, tl, tc


def test_prefill_logits_and_cache(tiny_prefilled):
    _, _, jl, jc, tl, tc = tiny_prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_LOGIT_ATOL)
    _close_cache(jc, tc, 1)


def test_extend_prefill_matches(tiny):
    jp, tp = _stack(tiny)
    ids, _ = _prompt(5, 1, 12, TINY.vocab_size, [12])
    jc, tc = _caches(TINY, 1, 48)
    _, jc = jlm.prefill(jp, TINY, jnp.asarray(ids[:, :7]), jnp.asarray([7], jnp.int32), jc)
    _, tc = tlm.prefill(tp, tcfg_of(TINY), torch.from_numpy(ids[:, :7]).long(),
                        torch.tensor([7], dtype=torch.int32), tc)
    suffix = np.zeros((1, 16), np.int32)           # padded to a bucket: 5 valid
    suffix[:, :5] = ids[:, 7:]
    jl, jc2 = jlm.extend_prefill(jp, TINY, jc, jnp.asarray(suffix), jnp.asarray([7], jnp.int32),
                                 jnp.asarray([5], jnp.int32))
    tc_before = tc.clone()
    tl, tc2 = tlm.extend_prefill(tp, tcfg_of(TINY), tc, torch.from_numpy(suffix).long(),
                                 torch.tensor([7], dtype=torch.int32),
                                 torch.tensor([5], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_LOGIT_ATOL)
    _close_cache(jc2, tc2, 1)
    assert int(tc2.length[0]) == 12
    assert torch.equal(tc.k, tc_before.k)          # the input cache is untouched


@pytest.mark.parametrize("stacked", [True, False])
def test_decode_step_scan_matches(tiny, tiny_prefilled, stacked):
    """Both decode forms of the JAX package: the stacked layer scan (self term,
    write after the layers) and the layer list (write, then attend)."""
    _, _, _, jc, _, tc = tiny_prefilled
    jp, tp = _stack(tiny) if stacked else tiny
    tok = np.asarray([3, 77], np.int32)
    jl, jc2 = jlm.decode_step(jp, TINY, jc, jnp.asarray(tok))
    tl, tc2 = tlm.decode_step(tp, tcfg_of(TINY), tc.clone(), torch.from_numpy(tok).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_LOGIT_ATOL)
    _close_cache(jc2, tc2, 1)


@pytest.fixture(scope="module")
def wide_fused(wide):
    jp = jlm.fuse_serving_params(jlm.ensure_quantized_head(wide[0]))
    tp = tlm.fuse_serving_params(tlm.ensure_quantized_head(wide[1]))
    return jp, tp


def test_wide_q8_decode_logits(wide_fused):
    jp, tp = wide_fused
    ids, lens = _prompt(7, 2, 20, WIDE.vocab_size, [20, 13])
    jc, tc = _caches(WIDE, 2, 128)
    jl0, jc = jlm.prefill(jp, WIDE, jnp.asarray(ids), jnp.asarray(lens), jc)
    tl0, tc = tlm.prefill(tp, tcfg_of(WIDE), torch.from_numpy(ids).long(),
                          torch.from_numpy(lens), tc)
    tok = np.asarray([5, 400], np.int32)
    jl, jc2 = jlm.decode_step(jp, WIDE, jc, jnp.asarray(tok))
    tl, tc2 = tlm.decode_step(tp, tcfg_of(WIDE), tc, torch.from_numpy(tok).long(),
                              decode_mega="0")
    for t_, j in ((tl0, jl0), (tl, jl)):
        j = np.asarray(j)
        assert np.abs(t_.numpy() - j).max() <= BF16_REL * np.abs(j).max()
        np.testing.assert_array_equal(t_.numpy().argmax(-1), j.argmax(-1))
    _close_cache(jc2, tc2, 2)


# ---------------------------------------------------------------------------
# serving transforms, field for field
# ---------------------------------------------------------------------------

def _fields_equal(t_qt, j_qt):
    assert isinstance(t_qt, QuantTensor) and t_qt.fmt == j_qt.fmt
    assert tuple(t_qt.shape) == tuple(j_qt.shape)
    for f, a in t_qt.fields().items():
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(getattr(j_qt, f), np.float32),
                                      f)


def test_fuse_and_quantized_head_field_exact(wide_fused):
    jp, tp = wide_fused
    for name in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
        _fields_equal(tp["layers"][name]["kernel"], jp["layers"][name]["kernel"])
        assert tp["layers"][name]["kernel"].scales.dtype == torch.float32
    assert "q_proj" not in tp["layers"] and "gate_proj" not in tp["layers"]
    for name in ("input_norm", "post_norm", "q_norm", "k_norm"):
        np.testing.assert_array_equal(tp["layers"][name].float().numpy(),
                                      np.asarray(jp["layers"][name], np.float32))
    # the head: field for field with the reference numpy quantizer of the
    # padded emb.T; the JAX package's jitted quantizer lands one step away
    # on a rounding boundary in a few of its half-million values
    head = tp["lm_head"]["kernel"]
    assert head.shape == (256, 2048)                          # vocab padded to 2048
    emb = np.asarray(jp["embed_tokens"], np.float32)
    w = np.pad(emb.T, ((0, 0), (0, 2048 - emb.shape[0])))
    _fields_equal(head, quantize_q8_0_np(w))
    jd = np.asarray(jp["lm_head"]["kernel"].data, np.int32)
    diff = np.abs(head.data.numpy().astype(np.int32) - jd)
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4
    np.testing.assert_array_equal(head.scales.numpy(),
                                  np.asarray(jp["lm_head"]["kernel"].scales, np.float32))


def test_from_jax_numpy_carries_the_serving_tree(wide_fused):
    """A stacked, fused, quantized-head tree of the JAX package reaches the
    port field for field (dtypes included) through weights.from_jax_numpy."""
    jp = wide_fused[0]
    tp = weights.from_jax_numpy(jp)
    assert set(tp["layers"]) == set(jp["layers"])
    for name in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
        qt, jqt = tp["layers"][name]["kernel"], jp["layers"][name]["kernel"]
        assert qt.stacked and qt.data.dtype == torch.int8 and qt.scales.dtype == torch.float32
        _fields_equal(qt, jqt)
    _fields_equal(tp["lm_head"]["kernel"], jp["lm_head"]["kernel"])
    assert tp["embed_tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed_tokens"].float().numpy(),
                                  np.asarray(jp["embed_tokens"], np.float32))


def test_quantized_head_only_for_quantized_layers(tiny):
    assert tlm.ensure_quantized_head(tiny[1]).get("lm_head") is None
    assert tlm.fuse_serving_params(tiny[1]) is tiny[1]       # a layer list stays as it is


def test_slice_head_cols_field_exact(wide_fused):
    jp = wide_fused[0]
    head = jp["lm_head"]["kernel"]                  # the same head on both sides
    jred, jn, jv = jlm._slice_head_cols(head, 32, 160, eos=300)
    tred, tn, tv = tlm._slice_head_cols(weights.from_jax_numpy(head), 32, 160, eos=300)
    assert (tn, tv) == (jn, jv) == (128, 129)
    _fields_equal(tred, jred)
    emb = np.asarray(jp["embed_tokens"], np.float32)
    jred_t, _, _ = jlm._slice_head_cols(jnp.asarray(emb).T, 10, 50, eos=None, pad_multiple=64)
    tred_t, _, _ = tlm._slice_head_cols(torch.from_numpy(emb).t(), 10, 50, eos=None,
                                        pad_multiple=64)
    np.testing.assert_array_equal(tred_t.numpy(), np.asarray(jred_t))


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.95])
def test_top_p_keep_set(top_p):
    rng = np.random.default_rng(int(top_p * 100))
    logits = (rng.standard_normal((4, 2048)) * 3).astype(np.float32)
    probs_j = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    probs_t = torch.softmax(torch.from_numpy(logits), dim=-1)
    keep_j = np.asarray(probs_j >= jlm._top_p_threshold(probs_j, top_p))
    keep_t = (probs_t >= tlm._top_p_threshold(probs_t, top_p)).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    mass = (probs_t.numpy() * keep_t).sum(-1)
    assert (mass >= top_p - 1e-6).all()


# ---------------------------------------------------------------------------
# greedy generation, token for token
# ---------------------------------------------------------------------------

GEN_CASES = {
    "plain": (dict(temperature=0.0, max_new_tokens=6), False),
    "codes": (dict(temperature=0.0, max_new_tokens=12, allowed_range=(10, 50), eos_token=3,
                   min_tokens=8, forced_eos_at=8), False),
    "stop": (dict(temperature=0.0, max_new_tokens=6, stop_tokens=(7,)), False),
    "cfg": (dict(temperature=0.0, max_new_tokens=5, cfg_scale=3.0), True),
}


@pytest.fixture(scope="module")
def jax_generated(tiny):
    """The JAX package's greedy tokens for every case (one compile each)."""
    ids, lens = _prompt(3, 2, 7, TINY.vocab_size, [7, 5])
    out = {}
    for name, (kw, uncond) in GEN_CASES.items():
        extra = {}
        if uncond:
            extra = dict(uncond_prompt_ids=jnp.asarray([[9, 9], [9, 9]], jnp.int32),
                         uncond_prompt_lengths=jnp.asarray([2, 2], jnp.int32))
        toks, n = jlm.generate(tiny[0], TINY, jnp.asarray(ids), jnp.asarray(lens),
                               jax.random.key(0), jlm.SamplingParams(**kw), **extra)
        out[name] = (np.asarray(toks), np.asarray(n))
    return ids, lens, out


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_greedy_generate_tokens_identical(tiny, jax_generated, case):
    ids, lens, ref = jax_generated
    kw, uncond = GEN_CASES[case]
    extra = {}
    if uncond:
        extra = dict(uncond_prompt_ids=torch.tensor([[9, 9], [9, 9]]),
                     uncond_prompt_lengths=torch.tensor([2, 2], dtype=torch.int32))
    toks, n = tlm.generate(tiny[1], tcfg_of(TINY), torch.from_numpy(ids).long(),
                           torch.from_numpy(lens), None, tlm.SamplingParams(**kw), **extra)
    np.testing.assert_array_equal(toks.numpy(), ref[case][0])
    np.testing.assert_array_equal(n.numpy(), ref[case][1])
    if case == "codes":
        assert (n.numpy() == 9).all() and (toks.numpy()[:, 8] == 3).all()


@pytest.mark.parametrize("stacked", [True, False])
def test_greedy_generate_fp8_cache(tiny, monkeypatch, stacked):
    """The fp8 KV cache (ACESTEP_TPU_KV_DTYPE=fp8 in the JAX package, kv_dtype
    here) takes the plain decode forms; greedy codes token for token."""
    jp, tp = _stack(tiny) if stacked else tiny
    ids, lens = _prompt(17, 2, 7, TINY.vocab_size, [7, 6])
    kw = dict(temperature=0.0, max_new_tokens=8, allowed_range=(10, 90), eos_token=3,
              min_tokens=5, forced_eos_at=6)
    monkeypatch.setenv("ACESTEP_TPU_KV_DTYPE", "fp8")
    jax.clear_caches()
    ref = jlm.generate(jp, TINY, jnp.asarray(ids), jnp.asarray(lens), jax.random.key(0),
                       jlm.SamplingParams(**kw))
    jax.clear_caches()
    got = tlm.generate(tp, tcfg_of(TINY), torch.from_numpy(ids).long(), torch.from_numpy(lens),
                       None, tlm.SamplingParams(**kw), kv_dtype="fp8")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_reduced_codes_head_matches_full(tiny):
    """Greedy codes through the reduced head == through the full vocab."""
    ids, lens = _prompt(11, 2, 6, TINY.vocab_size, [6, 6])
    sp = tlm.SamplingParams(temperature=0.0, max_new_tokens=10, allowed_range=(16, 80),
                            eos_token=5, min_tokens=3, forced_eos_at=8)
    args = (tiny[1], tcfg_of(TINY), torch.from_numpy(ids).long(), torch.from_numpy(lens),
            None, sp)
    a = tlm.generate(*args, reduced_codes_head=True)
    b = tlm.generate(*args, reduced_codes_head=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_sampling_is_seeded_and_constrained(tiny):
    ids, lens = _prompt(13, 1, 6, TINY.vocab_size, [6])
    sp = tlm.SamplingParams(temperature=0.9, top_p=0.9, top_k=50, max_new_tokens=10,
                            allowed_range=(16, 80), eos_token=5, min_tokens=6,
                            forced_eos_at=6)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tlm.generate(tiny[1], tcfg_of(TINY), torch.from_numpy(ids).long(),
                            torch.from_numpy(lens), g, sp)

    (t1, n1), (t2, _), (t3, _) = run(1), run(1), run(2)
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    assert int(n1[0]) == 7 and int(t1[0, 6]) == 5
    assert ((t1[0, :6] >= 16) & (t1[0, :6] < 80)).all()


def test_prefix_cache_lookup():
    pc = tlm.PrefixCache(max_entries=2)
    c = tkvc.init_cache(1, 1, 2, 128, 16)
    pc.insert([1, 2, 3], c, torch.zeros(1, 8))
    hit = pc.lookup([1, 2, 3, 4, 5])
    assert hit is not None and hit[0] == 3 and hit[1] is c
    assert pc.lookup([9, 9]) is None
    pc.insert([7], c, torch.zeros(1, 8))
    pc.insert([8], c, torch.zeros(1, 8))
    assert pc.lookup([1, 2, 3]) is None and (pc.hits, pc.misses) == (1, 2)


def test_knobs_are_checked(tiny_prefilled):
    _, tp, _, _, _, tc = tiny_prefilled
    with pytest.raises(ValueError, match="decode_attn"):
        tlm.decode_step(tp, tcfg_of(TINY), tc.clone(), torch.tensor([1, 2]), decode_attn="x")
    with pytest.raises(ValueError, match="decode_mega"):
        tlm.decode_step(tp, tcfg_of(TINY), tc.clone(), torch.tensor([1, 2]), decode_mega="on")
