"""One rank of the port's parallel CPU tests (tests/test_torch_parallel*.py),
and :class:`World`, which spawns a world of them.

    python tests/torch_parallel_worker.py SPEC RANK WORLD

SPEC is a pickle the test wrote: the ``file://`` store of the process group,
its backend and the ranks' device (gloo on the CPU unless given), the output
directory, the (dp, tp) meshes to form over the world in order, and the
cases, each with its mesh, its kind and its inputs (numpy
arrays and parameter trees whose quantized weights are objects with ``fmt``,
``shape`` and the field arrays, which ``weights.from_jax_numpy`` reads).  The
rank computes every case of every mesh and writes ``rank{RANK}.npz`` with one
array per case output.  It imports torch and the port only: no JAX.

The ``batcher`` case is the port's copy of the JAX package's rank-0 batcher
(tests/test_distributed_multiproc.py:126-179): rank 0 merges requests through
``ContinuousBatcher`` and broadcasts each merged request as a fixed-size
payload; every other rank loops on the broadcast and runs the same
``generate``; a stop payload ends the loop.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from acestep_tpu_torch import config as tcfg  # noqa: E402
from acestep_tpu_torch import pipeline, weights  # noqa: E402
from acestep_tpu_torch.models import dit, qwen, vae  # noqa: E402
from acestep_tpu_torch.ops.qlinear import precast_quant_scales  # noqa: E402
from acestep_tpu_torch.parallel import distributed, make_mesh, shard_params  # noqa: E402
from acestep_tpu_torch.parallel import tp as ptp  # noqa: E402
from acestep_tpu_torch.parallel.collective_matmul import (  # noqa: E402
    allreduce_matmul, row_parallel_linear)
from acestep_tpu_torch.parallel.lm_tp import LMTPContext  # noqa: E402
from acestep_tpu_torch.parallel.sharding import unshard_params  # noqa: E402
from acestep_tpu_torch.serving import kv_cache as kvc  # noqa: E402
from acestep_tpu_torch.serving import lm as lm_serving  # noqa: E402
from acestep_tpu_torch.serving.batcher import ContinuousBatcher  # noqa: E402
from acestep_tpu_torch.training import flow_matching as fm  # noqa: E402

_ENGINES = {}      # (mesh, engine fields) -> the engine, shared by the cases of a mesh


def _cfg(kind, d):
    return getattr(tcfg, kind)(**d)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def case_reduce(c, mesh, out):
    """bf16 partials summed over the tp group, the last rank's broadcast, and
    a row-parallel linear through the all-reduce and the ring matmul."""
    g = mesh.tp_group
    part = _t(c["parts"][g.index]).to(torch.bfloat16)
    out["sum"] = distributed.all_reduce(part, g).float().numpy()
    out["broadcast"] = distributed.broadcast(part.float(), g, src_index=g.size - 1).numpy()
    k_loc = c["x"].shape[-1] // mesh.tp
    sl = slice(g.index * k_loc, (g.index + 1) * k_loc)
    x, w = _t(c["x"][:, sl]), _t(c["w"][sl])
    out["allreduce"] = row_parallel_linear(x, w, g).numpy()
    out["ring"] = allreduce_matmul(x, w, g).numpy()


def case_global(c, mesh, out):
    """``distributed.global_mesh`` with LOCAL_WORLD_SIZE set to each of
    ``locals`` (ranks on one host): this rank's (dp, tp, dp_rank, tp_rank)."""
    old = os.environ.get("LOCAL_WORLD_SIZE")
    try:
        for local in c["locals"]:
            os.environ["LOCAL_WORLD_SIZE"] = str(local)
            m = distributed.global_mesh(device="cpu")
            out[f"local{local}"] = np.array([m.dp, m.tp, m.dp_rank, m.tp_rank])
    finally:
        if old is None:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
        else:
            os.environ["LOCAL_WORLD_SIZE"] = old


def _standin(hop):
    def decode(params, cfg, z):
        y = z[..., :2]
        y = y + 0.5 * torch.nn.functional.pad(y, (0, 0, 1, 0))[:, :-1]
        return torch.repeat_interleave(y, hop, dim=1)
    return decode


def case_decode(c, mesh, out):
    """The window-sharded decodes over every rank through the exact stand-in
    decoder (tests/test_torch_vae_windows.py)."""
    real, vae.decode = vae.decode, _standin(c["hop"])
    try:
        _decodes(c, mesh, out)
    finally:
        vae.decode = real


def _decodes(c, mesh, out):
    cfg = _cfg("VAEConfig", c["vae_cfg"])
    lat = _t(c["latents"])
    for wb in c["wbs"]:
        i16, scale = vae.fused_tiled_decode_int16(None, cfg, lat, chunk_frames=c["chunk"],
                                                  max_window_batch=wb, group=mesh.world)
        out[f"tiled_wb{wb}"] = i16.numpy()
        out[f"tiled_scale_wb{wb}"] = np.float32(scale)
        windows = vae._window_plan(lat.shape[1], c["chunk"], None)
        for j, (lo, hi, rel) in enumerate(pipeline.segment_windows(windows, c["chunk"])):
            i16, scale = vae.fused_decode_windows_int16(None, cfg, lat[:1, lo:hi], rel,
                                                        max_window_batch=wb, group=mesh.world)
            out[f"seg{j}_wb{wb}"] = i16.numpy()
            out[f"seg{j}_scale_wb{wb}"] = np.float32(scale)


def _engine(c, mesh):
    """The tiny random engine of ``c``'s fields on the mesh, built once."""
    key = (mesh.dp, mesh.tp, c.get("quant"), c["seed"], repr(c["dit_cfg"]),
           repr(c["vae_cfg"]), repr(c["text_cfg"]))
    if key not in _ENGINES:
        _ENGINES[key] = pipeline.build_random_engine(
            device="cpu", quant=c.get("quant"), seed=c["seed"],
            dit_cfg=_cfg("DiTConfig", c["dit_cfg"]), vae_cfg=_cfg("VAEConfig", c["vae_cfg"]),
            text_cfg=_cfg("QwenConfig", c["text_cfg"]), mesh=mesh)
    return _ENGINES[key]


def case_engine(c, mesh, out):
    """A tiny random engine on the mesh serving each request."""
    eng = _engine(c, mesh)
    for name, (req, noise) in c["requests"].items():
        res = eng.generate(pipeline.GenerationRequest(**req),
                           noise=None if noise is None else _t(noise))
        out[f"{name}_latents"] = res.latents
        out[f"{name}_audio"] = res.audio_i16


PAYLOAD = 256      # floats of a broadcast request (the JAX test's PAY)


def encode_request(req) -> np.ndarray:
    """A merged request as the fixed-size payload: [1 (run), batch, width,
    seeds at 3.., the padded style ids at 16.., then their mask].  A merged
    request's ids are padded to their token bucket, so the width travels
    explicitly."""
    buf = np.zeros(PAYLOAD, np.float32)
    ids, mask = np.asarray(req.style_token_ids), np.asarray(req.style_mask)
    buf[0], buf[1], buf[2] = 1.0, req.batch_size, ids.shape[1]
    buf[3:3 + len(req.seeds)] = req.seeds
    buf[16:16 + ids.size] = ids.ravel()
    buf[16 + ids.size:16 + 2 * ids.size] = mask.ravel()
    return buf


def decode_request(buf: np.ndarray, duration_s: float):
    b, w = int(buf[1]), int(buf[2])
    ids = buf[16:16 + b * w].astype(np.int64).reshape(b, w)
    mask = buf[16 + b * w:16 + 2 * b * w].astype(np.int32).reshape(b, w)
    return pipeline.GenerationRequest(duration_s=duration_s, durations_s=[duration_s] * b,
                                      batch_size=b, style_token_ids=ids, style_mask=mask,
                                      seeds=[int(s) for s in buf[3:3 + b]])


def case_batcher(c, mesh, out):
    """Rank 0's batcher over the mesh (module docstring): two requests of
    one style row each, merged into one batch and served by every rank."""
    eng, world = _engine(c, mesh), mesh.world
    style, dur = np.asarray(c["style"]), c["duration_s"]

    def bcast(buf):
        return distributed.broadcast(_t(buf), world).numpy()

    if world.index == 0:
        def run_merged(req):
            bcast(encode_request(req))
            return eng.generate(req)

        bat = ContinuousBatcher(run_merged, max_batch=2, max_wait_s=5.0).start()
        futs = [bat.submit(pipeline.GenerationRequest(
            duration_s=dur, batch_size=1, style_token_ids=style[i:i + 1],
            style_mask=np.ones((1, style.shape[1]), np.int32), seeds=[c["seeds"][i]]))
            for i in range(style.shape[0])]
        parts = [f.result(timeout=120) for f in futs]
        bat.stop()
        bcast(np.zeros(PAYLOAD, np.float32))                  # stop
        out["batches"] = np.int32(bat.stats["batches"])
        out["latents"] = np.concatenate([p.latents for p in parts], axis=0)
        return
    served = []
    while True:
        buf = bcast(np.zeros(PAYLOAD, np.float32))
        if buf[0] < 0.5:
            break
        served.append(eng.generate(decode_request(buf, dur)))
    out["batches"] = np.int32(len(served))
    out["latents"] = np.concatenate([r.latents for r in served], axis=0)


def case_grads(c, mesh, out):
    """The three collectives' gradients in a Megatron block: x replicated
    into a column-parallel w1 (``copy_to_group``), a replicated scale on the
    rank's columns (``copy_to_group``), a row-parallel w2 (``all_reduce``) and
    a whole w3 on the gathered columns (``all_gather_cat``)."""
    g = mesh.tp_group
    n = c["w1"].shape[1] // mesh.tp
    x, gain = _t(c["x"]).requires_grad_(), _t(c["gain"]).requires_grad_()
    w1 = _t(c["w1"][:, g.index * n:(g.index + 1) * n]).requires_grad_()
    w2 = _t(c["w2"][g.index * n:(g.index + 1) * n]).requires_grad_()
    w3 = _t(c["w3"]).requires_grad_()

    def block(x):
        h = torch.tanh(distributed.copy_to_group(x, g) @ w1)
        h = (h.reshape(h.shape[0], -1, gain.shape[0]) * distributed.copy_to_group(gain, g)
             ).reshape(h.shape)
        return distributed.all_reduce(h @ w2, g) + distributed.all_gather_cat(h, g) @ w3

    y = block(x)
    loss = (y * _t(c["r"])).sum()
    gx, ggain, g1, g2, g3 = torch.autograd.grad(loss, [x, gain, w1, w2, w3])
    out["y"], out["x"], out["gain"], out["w3"] = (y.detach().numpy(), gx.numpy(),
                                                  ggain.numpy(), g3.numpy())
    out["w1"] = distributed.all_gather_cat(g1, g, dim=1).numpy()
    out["w2"] = distributed.all_gather_cat(g2, g, dim=0).numpy()
    with torch.no_grad():      # no gradient asked: the plain collectives, the same bytes
        out["y_nograd"] = block(x).numpy()


def _train_batch(b):
    return {k: _t(v) for k, v in b.items()}


def case_train(c, mesh, out):
    """``make_tp_train_step`` on the rank's shards of a float DiT: its steps'
    losses and the whole tree after them (``unshard_params``), then a step on
    a batch with a NaN in dp rank 0's rows: params and state kept on every
    rank."""
    cfg = _cfg("DiTConfig", c["cfg"])
    opt = fm.make_optimizer(**c["opt"])
    params = shard_params(weights.from_jax_numpy(c["params"]), mesh)
    state = opt.init(params)
    step = ptp.make_tp_train_step(cfg, opt, mesh)
    for i, (batch, t, noise) in enumerate(c["steps"]):
        params, state, loss = step(params, state, _train_batch(batch), _t(t), _t(noise))
        out[f"loss{i}"] = np.float32(loss.item())
    for name, leaf in weights.flatten(unshard_params(params, mesh)).items():
        out[f"param/{name}"] = leaf.numpy()
    out["count"] = np.int32(state.count)
    batch, t, noise = c["nan_step"]
    new, new_state, loss = step(params, state, _train_batch(batch), _t(t), _t(noise))
    out["nan_loss"] = np.float32(loss.item())
    out["nan_kept"] = np.int32(new is params and new_state is state
                               and new_state.count == len(c["steps"]))


def case_align(c, mesh, out):
    """The lyric alignment probe on an engine of ``c``'s trees on the mesh:
    item 0's map, the stamps and LRC, the score."""
    eng = pipeline.AceStepEngine(
        weights.from_jax_numpy(c["dit"]), _cfg("DiTConfig", c["dit_cfg"]),
        weights.from_jax_numpy(c["vae"]), _cfg("VAEConfig", c["vae_cfg"]),
        weights.from_jax_numpy(c["text"]), _cfg("QwenConfig", c["text_cfg"]), device="cpu",
        mesh=mesh)
    req = pipeline.GenerationRequest(**c["request"])
    eps = _t(c["eps"])
    probe = eng.lyric_attention_map

    def recorded(*args, **kw):         # the map the score reads, kept
        out["map"], out["n_lyric"] = probe(*args, **kw)
        return out["map"], out["n_lyric"]

    eng.lyric_attention_map = recorded
    out["score"] = np.float64(eng.get_lyric_score(c["latents"], req, eps=eps))
    eng.lyric_attention_map = probe
    stamps, lrc = eng.get_lyric_timestamps(c["latents"], req, c["lines"], c["counts"], eps=eps)
    out["stamps"], out["lrc"] = stamps, np.asarray(lrc)


def case_qwen(c, mesh, out):
    """The Qwen stack's full-sequence forward on the rank's shards."""
    cfg = _cfg("QwenConfig", c["cfg"])
    p = qwen.stack_params(qwen.init_params(cfg, device="cpu", seed=c["seed"],
                                           dtype=torch.float32))
    ids = _t(c["ids"]).long()
    out["hidden"] = qwen.forward(shard_params(p, mesh), ptp.local_cfg(cfg, mesh.tp), ids,
                                 group=mesh.tp_group).numpy()


def _dit_params(c, mesh):
    tree = dit.stack_params(weights.from_jax_numpy(c["params"]))
    return shard_params(precast_quant_scales(tree), mesh)


def case_dit(c, mesh, out):
    cfg = _cfg("DiTConfig", c["cfg"])
    fwd = ptp.make_tp_dit_forward(cfg, mesh)
    out["out"] = fwd(_dit_params(c, mesh), _t(c["hs"]), _t(c["t"]), _t(c["enc"]),
                     _t(c["ctx"])).float().numpy()


def case_sampler(c, mesh, out):
    cfg = _cfg("DiTConfig", c["cfg"])
    run = ptp.make_tp_sampler(cfg, mesh)
    b = c["noise"].shape[0]
    lat = run(_dit_params(c, mesh), _t(c["noise"]), _t(c["ctx"]), _t(c["enc"]), None,
              tuple(c["schedule"]), batch_sharded=mesh.dp > 1 and b % mesh.dp == 0)
    out["out"] = lat.numpy()


def _lm_ctx(c, mesh):
    cfg = _cfg("QwenConfig", c["cfg"])
    p = lm_serving.ensure_quantized_head(qwen.stack_params(weights.from_jax_numpy(c["params"])))
    return LMTPContext(p, cfg, mesh), cfg


def _i32(a):
    return None if a is None else _t(np.asarray(a, np.int32))


def case_lm_generate(c, mesh, out):
    ctx, _ = _lm_ctx(c, mesh)
    sp = lm_serving.SamplingParams(**c["sp"])
    toks, n = ctx.generate(_t(c["prompt"]).long(), _i32(c["lengths"]), None, sp,
                           None if c.get("uncond") is None else _t(c["uncond"]).long(),
                           _i32(c.get("ulengths")), _i32(c.get("min_arr")),
                           _i32(c.get("forced_arr")))
    out["tokens"], out["n"] = toks.numpy(), n.numpy()
    out["head_red"] = np.int32(ctx.head_red(sp) is not None)


def case_lm_prefix(c, mesh, out):
    """prefill -> grow -> extend -> broadcast -> decode on the rank's cache."""
    ctx, cfg = _lm_ctx(c, mesh)
    sp = lm_serving.SamplingParams(**c["sp"])
    ids, suffix = c["ids"], c["suffix"]
    cache = ctx.init_cache(1, 128)
    logits, cache = ctx.prefill(_t(np.asarray([ids])).long(), _i32([len(ids)]), cache)
    cache = kvc.grow_cache(cache, c["total"])
    logits, cache = ctx.extend_prefill(cache, _t(np.asarray([suffix])).long(),
                                       _i32([len(ids)]), _i32([len(suffix)]))
    toks, n = ctx.decode_from_state(kvc.broadcast_cache(cache, 2), logits.expand(2, -1),
                                    None, sp)
    out["tokens"], out["n"] = toks.numpy(), n.numpy()


def card_dit(cfg_d, mesh, seed):
    """A q8_0 DiT drawn on the rank's device from ``seed``, stacked and cut
    for the mesh, with the same draws' inputs (tests/test_torch_cuda_parallel.py
    draws the same in one process)."""
    from acestep_tpu_torch.models.random_init import RandomInit

    cfg = _cfg("DiTConfig", cfg_d)
    init = RandomInit(mesh.device, seed, "q8_0")
    params = shard_params(precast_quant_scales(dit.stack_params(init.dit(cfg))), mesh)
    g = torch.Generator(device=mesh.device).manual_seed(seed + 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=mesh.device).to(torch.bfloat16)

    return cfg, params, (randn(2, 64, cfg.audio_acoustic_hidden_dim),
                         torch.tensor([0.7, 0.4], device=mesh.device),
                         randn(2, 20, cfg.hidden_size), randn(2, 64, cfg.context_dim))


def case_card_dit(c, mesh, out):
    cfg, params, (hs, t, enc, ctx) = card_dit(c["cfg"], mesh, c["seed"])
    out["out"] = ptp.make_tp_dit_forward(cfg, mesh)(params, hs, t, enc, ctx).float().cpu().numpy()


def case_card_lm(c, mesh, out):
    """A q8_0 LM drawn from ``seed``: prefill and one decode step on the
    decode-attention kernel (row 9) at the rank's KV heads."""
    cfg = _cfg("QwenConfig", c["cfg"])
    p = lm_serving.ensure_quantized_head(qwen.stack_params(
        qwen.init_params(cfg, device=mesh.device, seed=c["seed"], quant="q8_0")))
    ctx = LMTPContext(p, cfg, mesh, decode_attn="pallas")
    ids = torch.arange(5, 5 + 37, device=mesh.device)[None]
    cache = ctx.init_cache(1, 128)
    logits, cache = ctx.prefill(ids, _i32([37]).to(mesh.device), cache)
    logits, cache = ctx.decode_step(cache, logits.argmax(-1))
    out["logits"] = logits.cpu().numpy()


CARD_TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def card_train(cfg_d, device, seed):
    """(config, the groups the loss reads of an f32 DiT drawn on ``device``
    from ``seed`` as per-layer lists, a batch of two whose second item's last
    16 frames are out of the loss, two steps' draws), the inputs made with
    numpy: tests/test_torch_cuda_parallel.py makes the same in one process."""
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.sampler import SHIFT_TIMESTEPS

    cfg = _cfg("DiTConfig", cfg_d)
    tree = RandomInit(torch.device(device), seed, None, dtype=torch.float32).dit(cfg)
    tree["layers"] = unstack_layer_params(tree["layers"])
    rng = np.random.default_rng(seed)
    b, t, lc = 2, 64, 20
    batch = {"latents": rng.standard_normal((b, t, cfg.audio_acoustic_hidden_dim)),
             "context_latents": rng.standard_normal((b, t, cfg.context_dim)),
             "encoder_hidden_states": rng.standard_normal((b, lc, cfg.hidden_size)),
             "loss_mask": np.ones((b, t))}
    batch["loss_mask"][1, -16:] = 0.0
    batch = {k: _t(v.astype(np.float32)).to(device) for k, v in batch.items()}
    sched = np.asarray(SHIFT_TIMESTEPS[3.0], np.float32)
    draws = [(_t(sched[rng.integers(0, sched.size, b)]).to(device),
              _t(rng.standard_normal((b, t, cfg.audio_acoustic_hidden_dim))
                 .astype(np.float32)).to(device)) for _ in range(2)]
    return cfg, fm.loss_params(tree), batch, draws


def case_card_train(c, mesh, out):
    """Two ``make_tp_train_step`` steps of ``card_train``'s DiT on the card:
    the losses and the whole tree after them."""
    cfg, tree, batch, draws = card_train(c["cfg"], mesh.device, c["seed"])
    opt = fm.make_optimizer(**CARD_TRAIN_OPT)
    params = shard_params(tree, mesh)
    state = opt.init(params)
    step = ptp.make_tp_train_step(cfg, opt, mesh)
    for i, (t, noise) in enumerate(draws):
        params, state, loss = step(params, state, batch, t, noise)
        out[f"loss{i}"] = np.float32(loss.item())
    for name, leaf in weights.flatten(unshard_params(params, mesh)).items():
        out[f"param/{name}"] = leaf.cpu().numpy()


CASES = {"global": case_global, "reduce": case_reduce, "decode": case_decode,
         "engine": case_engine, "batcher": case_batcher, "grads": case_grads,
         "qwen": case_qwen, "dit": case_dit, "sampler": case_sampler, "train": case_train,
         "align": case_align, "lm_generate": case_lm_generate, "lm_prefix": case_lm_prefix,
         "card_dit": case_card_dit, "card_lm": case_card_lm, "card_train": case_card_train}


class World:
    """``world`` ranks of this worker spawned on the cases (one gloo process
    group over a ``file://`` store in ``workdir``); :meth:`wait` collects
    them.  The caller may compute its references in between."""

    def __init__(self, workdir: str, world: int, meshes, cases, timeout_s: float = 240.0,
                 backend: str = "gloo", device: str = "cpu"):
        self.workdir, self.world = workdir, world
        self.deadline = time.monotonic() + timeout_s
        spec = os.path.join(workdir, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"store": os.path.join(workdir, "store"), "out": workdir,
                         "meshes": meshes, "cases": cases, "backend": backend,
                         "device": device}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r),
                                        str(world)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True, cwd=REPO, env=env)
                      for r in range(world)]

    def wait(self):
        """Each rank's outputs (a dict of arrays); a rank still running at the
        deadline is killed, and a rank that failed fails the call."""
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(
                    timeout=max(1.0, self.deadline - time.monotonic()))[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of world {self.world} failed "
                                   f"({p.returncode}):\n{log}")
        out = []
        for r in range(self.world):
            with np.load(os.path.join(self.workdir, f"rank{r}.npz")) as z:
                out.append({k: z[k] for k in z.files})
        return out


def main() -> int:
    spec_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    distributed.initialize(spec["backend"], "file://" + spec["store"], world, rank,
                           timeout_s=120)
    out = {}
    for dp, tp in spec["meshes"]:
        mesh = make_mesh(dp=dp, tp=tp, device=spec["device"])
        for name, c in spec["cases"].items():
            if tuple(c["mesh"]) == (dp, tp):
                res = {}
                CASES[c["kind"]](c, mesh, res)
                out.update({f"{name}/{k}": v for k, v in res.items()})
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
