"""Port parity of tensor-parallel serving (acestep_tpu_torch.parallel.tp and
lm_tp) against the JAX package's shard_map versions, on the CPU.

The JAX side runs on the conftest's 8-device CPU mesh in this process; the
port side runs in spawned gloo worker processes that import no JAX
(tests/torch_parallel_worker.py): one spawn a world size, every case of that
world computed in it, the results back through numpy files, each case then
checked by a parametrised test.  World 2 forms the (dp, tp) = (1, 2) mesh;
world 4 forms (1, 4) and then (2, 2).

  * the DiT forward at (1, 2), (1, 4) and (2, 2) in f32, q8_0 and q4_k
    against ``make_tp_dit_forward`` at tp 4 (one reference a format: the TP
    forward is the same function at every mesh, to float reassociation, which
    the JAX test's 2e-4 covers, tests/test_sharding.py).  In f32 within that
    2e-4.  The quantized forwards at the bf16 gate of
    tests/test_torch_models.py: the JAX linear rounds the dequantized weight
    to bf16 (ops/qlinear.py:111), the port's plain version keeps it in f32.
    At q4_k the JAX TP forward cannot run a row-parallel weight (its
    dequantize unpacks the nibbles by the weight's global K, not the
    shard's), so q4_k is held to the JAX single-device forward, the function
    the TP forward computes;
  * the whole TP sampler at (2, 2) (the batch split over dp), the same noise
    given to both, against ``make_tp_sampler`` at the bf16 gate of
    tests/test_torch_models.py (the DiT steps run in bf16 in both packages,
    which round at other places);
  * the LM planner: greedy tokens equal to ``LMTPContext.generate`` for f32
    at (1, 2), (2, 2) and (1, 4) (against the JAX context at (1, 2): the JAX
    package's own tests hold its TP tokens equal at every mesh), the q8_0
    vocab-sharded head, CFG pairing,
    the codes phase's reduced head with per-row forced EOS, and the prefix
    flow (prefill, grow, extend, broadcast, decode) (tests/test_lm_tp.py);
  * every rank's output equal bit for bit.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig, QwenConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.parallel.lm_tp import LMTPContext as JLMTPContext
from acestep_tpu.parallel.tp import make_tp_dit_forward, make_tp_sampler
from acestep_tpu.quant import QuantTensor, quantize_tree
from acestep_tpu.serving import lm as jlm
from tests.test_torch_models import assert_bf16_close
from tests.torch_parallel_worker import World

# o_proj / down_proj K = 1024: 256 a rank at tp 4, whole q4_k super-blocks
DIT = DiTConfig(
    hidden_size=256, intermediate_size=1024, num_hidden_layers=1,
    num_attention_heads=8, num_key_value_heads=4, head_dim=128,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=0, num_timbre_encoder_hidden_layers=0,
    timbre_hidden_dim=8,
)
LM = QwenConfig(vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=8, intermediate_size=128, head_dim=16)
# quantized: hidden % 256 == 0 (the quantized head), per-rank K whole q8_0 blocks
LM_Q = QwenConfig(vocab_size=320, hidden_size=256, num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=8, intermediate_size=512, head_dim=32)
DIT_FORMATS = (None, "q8_0", "q4_k")
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
PROMPT = np.asarray([[3, 14, 15, 92, 6, 53], [5, 8, 9, 7, 0, 0]], np.int32)
LENGTHS = np.asarray([6, 4], np.int32)
UNCOND = np.asarray([[7, 2, 1, 0, 0, 0], [9, 4, 0, 0, 0, 0]], np.int32)
ULENGTHS = np.asarray([3, 2], np.int32)
CODES = dict(temperature=0.0, max_new_tokens=12, allowed_range=(200, 280), eos_token=3)
FORCED = np.asarray([8, 5], np.int32)
PREFIX_IDS, SUFFIX = [3, 14, 15, 92, 6, 53, 5, 8], [9, 7, 1]


def _jmesh(dp, tp):
    return Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))


def _np_tree(tree):
    """A JAX parameter tree as numpy, quantized weights as plain objects the
    worker's ``weights.from_jax_numpy`` reads."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    if isinstance(tree, QuantTensor):
        return types.SimpleNamespace(fmt=tree.fmt, shape=tuple(tree.shape), **{
            f: np.asarray(getattr(tree, f)) for f in ("data", "data_hi", "scales", "sub_scales",
                                                      "sub_mins", "super_scales", "super_mins")
            if getattr(tree, f) is not None})
    return None if tree is None else np.asarray(tree)


def _policy(fmt):
    block = 32 if fmt == "q8_0" else 256
    return lambda path, a: (getattr(a, "ndim", 0) == 2 and path.endswith("kernel")
                            and a.shape[0] % block == 0 and "embed_tokens" not in path)


def _dit_params(fmt):
    p = jdit.init_params(jax.random.key(0), DIT, dtype=jnp.float32)
    return jdit.stack_params(quantize_tree(p, fmt, policy=_policy(fmt)) if fmt else p)


def _lm_params(cfg, key, fmt=None):
    p = jqwen.init_params(jax.random.key(key), cfg, dtype=jnp.float32, scale=0.1)
    return jqwen.stack_params(quantize_tree(p, fmt, policy=_policy(fmt)) if fmt else p)


def _dit_inputs():
    rng = np.random.default_rng(0)
    return dict(hs=rng.standard_normal((2, 12, 8)).astype(np.float32),
                ctx=rng.standard_normal((2, 12, 16)).astype(np.float32),
                enc=rng.standard_normal((2, 5, 256)).astype(np.float32),
                t=np.asarray([0.7, 0.4], np.float32))


def _sampler_inputs():
    rng = np.random.default_rng(1)
    return dict(noise=rng.standard_normal((2, 12, 8)).astype(np.float32),
                ctx=rng.standard_normal((2, 12, 16)).astype(np.float32),
                enc=rng.standard_normal((2, 5, 256)).astype(np.float32),
                schedule=list(jsampler.get_timestep_schedule(3.0)))


def _lm_cases():
    """(name -> (mesh, config, JAX key, format, worker case fields))."""
    gen = dict(prompt=PROMPT, lengths=LENGTHS)
    greedy = dict(temperature=0.0, max_new_tokens=8)
    cases = {f"lm_f32_{dp}x{tp}": ((dp, tp), LM, 0, None, dict(gen, sp=greedy))
             for dp, tp in ((1, 2), (2, 2), (1, 4))}       # one JAX reference: (1, 2)
    cases["lm_q8_head"] = ((1, 4), LM_Q, 0, "q8_0", dict(gen, sp=greedy))
    cases["lm_cfg"] = ((2, 2), LM, 0, None, dict(
        gen, sp=dict(temperature=0.0, max_new_tokens=6, cfg_scale=2.0), uncond=UNCOND,
        ulengths=ULENGTHS))
    cases["lm_codes"] = ((1, 2), LM_Q, 0, "q8_0", dict(gen, sp=CODES, min_arr=FORCED,
                                                       forced_arr=FORCED))
    return cases


def _jax_lm(mesh, cfg, key, fmt, c):
    ctx = JLMTPContext(jlm.ensure_quantized_head(_lm_params(cfg, key, fmt)), cfg,
                       _jmesh(*mesh))
    sp = jlm.SamplingParams(**c["sp"])
    kw = {}
    if "uncond" in c:
        kw = dict(uncond_prompt_ids=jnp.asarray(c["uncond"]),
                  uncond_prompt_lengths=jnp.asarray(c["ulengths"]))
    if "min_arr" in c:
        assert ctx._head_red(sp) is not None          # the reduced head is in play
        kw.update(min_tokens_arr=jnp.asarray(c["min_arr"]),
                  forced_eos_arr=jnp.asarray(c["forced_arr"]))
    toks, n = ctx.generate(jnp.asarray(c["prompt"]), jnp.asarray(c["lengths"]),
                           jax.random.key(0), sp, **kw)
    return np.asarray(toks), np.asarray(n)


def _jax_prefix(mesh):
    """tests/test_lm_tp.py's prefix flow on the JAX TP context."""
    from acestep_tpu.serving import kv_cache as jkvc

    cfg = LM
    sp = jlm.SamplingParams(temperature=0.0, max_new_tokens=6)
    total = jkvc.round_len(len(PREFIX_IDS) + len(SUFFIX) + sp.max_new_tokens + 2)
    ctx = JLMTPContext(jlm.ensure_quantized_head(_lm_params(cfg, 0)), cfg, _jmesh(*mesh))
    cache = jkvc.init_cache(cfg.num_hidden_layers, 1, cfg.num_key_value_heads, 128,
                            cfg.head_dim)
    logits, cache = ctx.prefill(jnp.asarray([PREFIX_IDS], jnp.int32),
                                jnp.asarray([len(PREFIX_IDS)], jnp.int32), cache)
    cache = jkvc.grow_cache(cache, total)
    logits, cache = ctx.extend_prefill(cache, jnp.asarray([SUFFIX], jnp.int32),
                                       jnp.asarray([len(PREFIX_IDS)], jnp.int32),
                                       jnp.asarray([len(SUFFIX)], jnp.int32))
    toks, n = ctx.decode_from_state(jkvc.broadcast_cache(cache, 2),
                                    jnp.broadcast_to(logits, (2, logits.shape[-1])),
                                    jax.random.key(3), sp)
    return np.asarray(toks), np.asarray(n), total


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: (JAX reference, each rank's port outputs).  The worlds are
    spawned first and the JAX references computed while they run."""
    cases = {w: {} for w in MESHES}
    world_of = {m: w for w, ms in MESHES.items() for m in ms}
    dit_in = _dit_inputs()
    dit_params = {fmt: _dit_params(fmt) for fmt in DIT_FORMATS}
    for fmt, params in dit_params.items():
        for dp, tp in world_of:
            cases[world_of[(dp, tp)]][f"dit_{fmt}_{dp}x{tp}"] = dict(
                kind="dit", mesh=(dp, tp), cfg=dataclasses.asdict(DIT),
                params=_np_tree(params), **dit_in)
    s_in = _sampler_inputs()
    cases[4]["sampler"] = dict(kind="sampler", mesh=(2, 2), cfg=dataclasses.asdict(DIT),
                               params=_np_tree(dit_params[None]), **s_in)
    lm_cases = _lm_cases()
    for name, (mesh, cfg, key, fmt, c) in lm_cases.items():
        cases[world_of[mesh]][name] = dict(kind="lm_generate", mesh=mesh,
                                           cfg=dataclasses.asdict(cfg),
                                           params=_np_tree(_lm_params(cfg, key, fmt)), **c)
    total = 128
    cases[4]["lm_prefix"] = dict(kind="lm_prefix", mesh=(1, 4), cfg=dataclasses.asdict(LM),
                                 params=_np_tree(_lm_params(LM, 0)), ids=PREFIX_IDS,
                                 suffix=SUFFIX, total=total,
                                 sp=dict(temperature=0.0, max_new_tokens=6))
    worlds = {w: World(str(tmp_path_factory.mktemp(f"world{w}")), w, MESHES[w], cases[w])
              for w in MESHES}

    refs = {}
    args = [jnp.asarray(dit_in[k]) for k in ("hs", "t", "enc", "ctx")]
    for fmt, params in dit_params.items():
        if fmt == "q4_k":
            hs, t, enc, ctx = args
            refs[f"dit_{fmt}"] = np.asarray(jax.jit(
                lambda p, h, tt, e, c: jdit.forward(p, DIT, h, tt, tt, e, c))(
                    params, hs, t, enc, ctx))
        else:
            refs[f"dit_{fmt}"] = np.asarray(make_tp_dit_forward(
                DIT, _jmesh(1, 4), params)(params, *args))
    run = make_tp_sampler(DIT, _jmesh(2, 2), dit_params[None])
    refs["sampler"] = np.asarray(run(
        dit_params[None], jnp.asarray(s_in["noise"]), jnp.asarray(s_in["ctx"]),
        jnp.asarray(s_in["enc"]), None, jax.random.key(0), None,
        schedule=tuple(s_in["schedule"]), batch_sharded=True))
    for name, (mesh, cfg, key, fmt, c) in lm_cases.items():
        if not name.startswith("lm_f32") or name == "lm_f32_1x2":
            refs[name] = _jax_lm(mesh, cfg, key, fmt, c)
    for name in ("lm_f32_2x2", "lm_f32_1x4"):
        refs[name] = refs["lm_f32_1x2"]
    toks, n, jtotal = _jax_prefix((1, 4))
    assert jtotal == total
    refs["lm_prefix"] = (toks, n)
    ranks = {w: worlds[w].wait() for w in MESHES}
    return refs, {name: ranks[w] for w in MESHES for name in cases[w]}


def _outputs(ranks, name, key):
    """The case's output on every rank, checked equal bit for bit."""
    outs = [r[f"{name}/{key}"] for r in ranks[name]]
    for r, o in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(o, outs[0], err_msg=f"{name}: rank {r} != rank 0")
    return outs[0]


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("fmt", DIT_FORMATS)
def test_dit_forward_matches_jax_tp(runs, mesh, fmt):
    refs, ranks = runs
    got = _outputs(ranks, f"dit_{fmt}_{mesh[0]}x{mesh[1]}", "out")
    if fmt is None:
        np.testing.assert_allclose(got, refs[f"dit_{fmt}"], atol=2e-4, rtol=2e-4)
    else:
        assert_bf16_close(got, refs[f"dit_{fmt}"])


def test_tp_sampler_matches_jax(runs):
    refs, ranks = runs
    got = _outputs(ranks, "sampler", "out")
    assert np.isfinite(got).all()
    assert_bf16_close(got, refs["sampler"])


@pytest.mark.parametrize("name", sorted(_lm_cases()) + ["lm_prefix"])
def test_lm_tokens_equal_jax_tp(runs, name):
    refs, ranks = runs
    toks, n = refs[name]
    np.testing.assert_array_equal(_outputs(ranks, name, "tokens"), toks)
    np.testing.assert_array_equal(_outputs(ranks, name, "n"), n)
    if name == "lm_codes":
        assert _outputs(ranks, name, "head_red") == 1            # the reduced head ran
        got = _outputs(ranks, name, "tokens")
        assert got[0, 8] == CODES["eos_token"] and got[1, 5] == CODES["eos_token"]
        assert ((got[0, :8] >= 200) & (got[0, :8] < 280)).all()
