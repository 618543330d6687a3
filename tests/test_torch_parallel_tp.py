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
  * the full fine-tune step over the mesh (``make_tp_train_step``) at (1, 2),
    (1, 4) and (2, 2): two steps (the first at warm-up lr 0) on the JAX
    draws, the whole tree gathered back (``unshard_params``) against the JAX
    package's unsharded ``make_train_step`` within
    tests/test_torch_training.py's FULL_TOL (tree) and UPDATE_TOL (update),
    the jitted step that test_three_steps_match_jax[full] holds the port's
    one-process step to and those bounds were set against (the eager step
    costs ~45 s of op-by-op compiles here; measured against it the meshed
    trees part by 0.029 / 0.120 / 0.029 and the updates by 0.0085 / 0.035 /
    0.0099, against the jitted one by 0.058 / 0.184 / 0.038 and 0.022 /
    0.052 / 0.022);
    the first step's loss against the port's one-process loss on the batch
    whose items have uneven loss masks, at that file's per-step loss bound;
    a NaN in dp rank 0's rows keeps the params and the optimizer state on
    every rank.  The DiT is that file's TINY with four query and four KV
    heads (tp 4 must divide both).  At a two-layer, 64-wide DiT the JAX
    package's own jitted and eager steps part by 0.212 on the tree metric
    (its zero-initialised ``scale_shift_table`` holds only the update, so one
    element whose Adam ratio turns over sets the max), above FULL_TOL, which
    was set at TINY; at TINY with four heads they part by 0.063;
  * the lyric alignment probe on a meshed q8_0 engine (eight query and four
    KV heads) at (1, 2), (1, 4) and (2, 2): its map against the JAX probe on
    the unsharded engine within tests/test_torch_alignment.py's MAP_ATOL,
    its score within ENGINE_SCORE_RTOL, its stamps within one patch of the
    JAX ones (90% equal), as that file holds the one-process engine;
  * every rank's output equal bit for bit.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from acestep_tpu import alignment as jalign
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig, QwenConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.parallel.lm_tp import LMTPContext as JLMTPContext
from acestep_tpu.parallel.tp import make_tp_dit_forward, make_tp_sampler
from acestep_tpu.quant import QuantTensor, quantize_tree, quantize_tree_jax
from acestep_tpu.serving import lm as jlm
from acestep_tpu.training import flow_matching as jfm
from acestep_tpu_torch import weights
from acestep_tpu_torch.config import DiTConfig as TDiTConfig
from acestep_tpu_torch.training import flow_matching as tfm
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_alignment import ENGINE_SCORE_RTOL, MAP_ATOL, STAMP_EQUAL_SHARE
from tests.test_torch_models import (KERNEL_GAIN, SLICE_VAE, _quant_policy, _scale_kernels,
                                     _vae_params, assert_bf16_close)
from tests.test_torch_training import (FULL_TOL, TINY as TRAIN_TINY, UPDATE_TOL, _batch,
                                       _tree_rel, _update_rel)
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
TP_MESHES = [(1, 2), (1, 4), (2, 2)]
TRAIN_DIT = dataclasses.replace(TRAIN_TINY, num_attention_heads=4, num_key_value_heads=4)
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-3         # tests/test_torch_training.py::test_three_steps_match_jax, each step
ALIGN_DIT = dataclasses.replace(TINY_DIT, num_attention_heads=8, num_key_value_heads=4)
ALIGN_T = 250            # 10 s in a 256-frame bucket


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


@jax.jit
def _jit_draws(key):
    """The jitted step's own draws for ``key`` (flow_matching.py:43-45)."""
    k_t, k_n = jax.random.split(key)
    return (jfm.sample_discrete_timesteps(k_t, 2),
            jax.random.normal(k_n, (2, 8, TRAIN_DIT.audio_acoustic_hidden_dim), jnp.float32))


def _train_inputs():
    """The float tree, each step's (batch, t, noise) from the JAX keys, the
    NaN step (item 0, dp rank 0's rows at dp 2) and the keys."""
    params = jax.jit(lambda k: jdit.init_params(k, TRAIN_DIT, dtype=jnp.float32))(
        jax.random.key(0))
    keys = [jax.random.key(100 + i) for i in range(2)]
    steps = [(_batch(i),) + tuple(np.asarray(x) for x in _jit_draws(k))
             for i, k in enumerate(keys)]
    nan = _batch(0)
    nan["latents"][0, 0, 0] = np.nan
    return params, steps, (nan,) + steps[0][1:], keys


def _jax_train(params, steps, keys):
    """The JAX package's unsharded jitted step on the same draws: (tree, losses)."""
    opt = jfm.make_optimizer(**TRAIN_OPT)
    step = jfm.make_train_step(TRAIN_DIT, opt, jit=True)
    tree, state, losses = params, opt.init(params), []
    for (b, _, _), key in zip(steps, keys):
        tree, state, loss = step(tree, state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        losses.append(float(loss))
    return tree, losses


def _align_inputs():
    """The probe's engine trees (q8_0, as tests/test_torch_models.jax_params
    makes them, at ALIGN_DIT) and request, latents and the JAX draw."""
    k1, k2, k3 = jax.random.split(jax.random.key(3), 3)
    rng = np.random.default_rng(3)

    def sampler(shape):
        return rng.standard_normal(shape).astype(np.float32)

    dp = quantize_tree_jax(_scale_kernels(jdit.init_params(k1, ALIGN_DIT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=_quant_policy)
    tp = quantize_tree_jax(_scale_kernels(jqwen.init_params(k3, TINY_TEXT, sampler=sampler),
                                          KERNEL_GAIN), "q8_0", policy=_quant_policy)
    vp = _vae_params(k2, SLICE_VAE, rng)
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((1, ALIGN_T, ALIGN_DIT.audio_acoustic_hidden_dim)).astype(np.float32)
    req = dict(duration_s=10.0, style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
               lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)), seeds=[1])
    eps = np.asarray(jax.random.normal(jax.random.key(0), (1, 256, lat.shape[-1]), jnp.float32))
    return (dp, tp, vp), req, lat, eps


def _jax_align(trees, req, lat):
    """The JAX engine's probe on the unsharded trees: (item 0's map, stamps,
    score), as its ``get_lyric_timestamps`` / ``get_lyric_score`` compute
    them (pipeline.py:940-996), the map once."""
    dp, tp, vp = trees
    eng = jpipeline.AceStepEngine(dp, ALIGN_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    jreq = jpipeline.GenerationRequest(**req)
    t = jpipeline.bucket_frames(ALIGN_T)
    pad = jnp.pad(jnp.asarray(lat), ((0, 0), (0, t - ALIGN_T), (0, 0)))
    enc, enc_mask = eng.build_condition(jreq, 1)
    ctx = eng.build_context_latents(jreq, 1, t, ALIGN_T)
    probe = jax.jit(jalign.cross_attention_maps, static_argnums=(1,))
    maps = np.asarray(probe(eng.dit_params, ALIGN_DIT, pad, ctx, enc, enc_mask)[0], np.float32)
    n_lyric = np.asarray(req["lyric_token_ids"]).shape[1]
    stamps = jalign.token_timestamps(maps, n_lyric, ALIGN_DIT.patch_size / 25.0)
    return maps, stamps, jalign.alignment_score(maps, n_lyric)


ALIGN_LINES, ALIGN_COUNTS = ["first line", "second line", "third"], [14, 13, 13]


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
    train_params, train_steps, nan_step, train_keys = _train_inputs()
    align_trees, align_req, align_lat, align_eps = _align_inputs()
    for dp, tp in TP_MESHES:
        cases[world_of[(dp, tp)]][f"train_{dp}x{tp}"] = dict(
            kind="train", mesh=(dp, tp), cfg=dataclasses.asdict(TRAIN_DIT), opt=TRAIN_OPT,
            params=_np_tree(train_params), steps=train_steps, nan_step=nan_step)
        cases[world_of[(dp, tp)]][f"align_{dp}x{tp}"] = dict(
            kind="align", mesh=(dp, tp), dit=_np_tree(align_trees[0]),
            text=_np_tree(align_trees[1]), vae=_np_tree(align_trees[2]),
            dit_cfg=dataclasses.asdict(ALIGN_DIT), text_cfg=dataclasses.asdict(TINY_TEXT),
            vae_cfg=dataclasses.asdict(SLICE_VAE), request=align_req, latents=align_lat,
            eps=align_eps, lines=ALIGN_LINES, counts=ALIGN_COUNTS)
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
    refs["train"] = _jax_train(train_params, train_steps, train_keys) + (train_params,)
    b, t, noise = train_steps[0]
    refs["train_loss0"] = float(tfm.flow_matching_loss(
        weights.from_jax_numpy(_np_tree(train_params)), TDiTConfig(**dataclasses.asdict(TRAIN_DIT)),
        {k: torch.from_numpy(v) for k, v in b.items()}, torch.from_numpy(t),
        torch.from_numpy(noise)))
    refs["align"] = _jax_align(align_trees, align_req, align_lat)
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


def _whole_tree(ranks, name, like):
    """The case's gathered tree (``param/<name>`` outputs) in ``like``'s
    structure, checked equal on every rank."""
    flat = {n: torch.from_numpy(_outputs(ranks, name, f"param/{n}"))
            for n, v in weights.flatten(like).items() if v is not None}

    def build(t, path=""):
        if isinstance(t, dict):
            return {k: build(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v, f"{path}/{i}") for i, v in enumerate(t)]
        return None if t is None else flat[path]

    return build(like)


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_meshed_train_step_matches_jax(runs, mesh):
    refs, ranks = runs
    name = f"train_{mesh[0]}x{mesh[1]}"
    jtree, jlosses, tree0 = refs["train"]
    got = _whole_tree(ranks, name, weights.from_jax_numpy(_np_tree(tree0)))
    for i, jl in enumerate(jlosses):
        tl = float(_outputs(ranks, name, f"loss{i}"))
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (i, tl, jl)
    assert int(_outputs(ranks, name, "count")) == 2
    err = _tree_rel(got, jtree)
    assert err <= FULL_TOL, err
    upd = _update_rel(got, jtree, tree0)
    assert upd <= UPDATE_TOL, upd


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_meshed_loss_divides_by_the_whole_mask(runs, mesh):
    """The first step's loss (the initial params) against the port's loss in
    one process on the same batch: at dp 2 the two items sit on two ranks
    with uneven loss masks (8 and 5 frames), and a mean of the ranks' own
    means parts from it by 3.7% (1.7419 against 1.6796)."""
    refs, ranks = runs
    got = float(_outputs(ranks, f"train_{mesh[0]}x{mesh[1]}", "loss0"))
    assert abs(got - refs["train_loss0"]) <= LOSS_RTOL * abs(refs["train_loss0"]), \
        (got, refs["train_loss0"])


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_meshed_nan_guard_agreed_on_every_rank(runs, mesh):
    """A NaN in item 0 (dp rank 0's rows at dp 2): every rank returns its
    params and optimizer state unchanged, count included, and the NaN loss."""
    _, ranks = runs
    name = f"train_{mesh[0]}x{mesh[1]}"
    assert np.isnan(_outputs(ranks, name, "nan_loss"))
    assert all(int(r[f"{name}/nan_kept"]) == 1 for r in ranks[name])


@pytest.mark.parametrize("mesh", TP_MESHES)
def test_meshed_alignment_probe_matches_jax(runs, mesh):
    refs, ranks = runs
    name = f"align_{mesh[0]}x{mesh[1]}"
    ref_map, ref_stamps, ref_score = refs["align"]
    got = _outputs(ranks, name, "map")
    assert got.shape == ref_map.shape
    err = float(np.abs(got - ref_map).max())
    assert err <= MAP_ATOL, err
    score = float(_outputs(ranks, name, "score"))
    assert abs(score - ref_score) <= ENGINE_SCORE_RTOL * abs(ref_score), (score, ref_score)
    stamps = _outputs(ranks, name, "stamps")
    patch_s = ALIGN_DIT.patch_size / 25.0
    assert stamps.shape == ref_stamps.shape == (40,)
    assert np.abs(stamps - ref_stamps).max() <= patch_s + 1e-9
    assert np.mean(np.abs(stamps - ref_stamps) < 1e-9) >= STAMP_EQUAL_SHARE
    lrc = str(_outputs(ranks, name, "lrc"))
    assert lrc.count("\n") == 2 and lrc.startswith("[00:")
    assert int(_outputs(ranks, name, "n_lyric")) == 40
