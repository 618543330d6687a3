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
from acestep_tpu_torch.serving import kv_cache as kvc  # noqa: E402
from acestep_tpu_torch.serving import lm as lm_serving  # noqa: E402


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


def case_engine(c, mesh, out):
    """A tiny random engine on the mesh serving each request."""
    eng = pipeline.build_random_engine(
        device="cpu", quant=c.get("quant"), seed=c["seed"],
        dit_cfg=_cfg("DiTConfig", c["dit_cfg"]), vae_cfg=_cfg("VAEConfig", c["vae_cfg"]),
        text_cfg=_cfg("QwenConfig", c["text_cfg"]), mesh=mesh)
    for name, (req, noise) in c["requests"].items():
        res = eng.generate(pipeline.GenerationRequest(**req),
                           noise=None if noise is None else _t(noise))
        out[f"{name}_latents"] = res.latents
        out[f"{name}_audio"] = res.audio_i16


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


CASES = {"global": case_global, "reduce": case_reduce, "decode": case_decode, "engine": case_engine, "qwen": case_qwen,
         "dit": case_dit, "sampler": case_sampler, "lm_generate": case_lm_generate,
         "lm_prefix": case_lm_prefix, "card_dit": case_card_dit, "card_lm": case_card_lm}


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
