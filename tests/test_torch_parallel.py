"""The port's parallel package (acestep_tpu_torch.parallel) on the CPU: the
mesh, the layout, the bootstrap and the collectives, the window-sharded VAE
decode and the meshed engine.

In this process: the tier table and ``local_cfg`` against the JAX package's;
shard round trips of all four quant formats (the column and row shards,
concatenated, dequantize to the whole weight bit for bit, and a weight whose
K cut would split a quant block stays whole); the row-parallel validation;
``initialize`` in one process (False) and at a bad address (raises).

In spawned gloo worlds (tests/torch_parallel_worker.py; world 2 forms
(dp, tp) = (1, 2), world 4 forms (1, 4) and then (2, 2)), every rank's
output equal bit for bit, and:
  * ``all_reduce`` of bf16 partials equal bit for bit to the JAX package's
    ``psum`` on its 8-device CPU mesh (f32 in rank order, rounded once),
    ``broadcast`` from the last rank, and the ring collective matmul against
    the all-reduce and numpy (1e-5);
  * the window-sharded decode (one-pass and segments; window batch 1 over
    two ranks, 3 over four, where the stack is padded) equal bit for bit to
    the JAX package's meshed decode, through the exact stand-in decoder of
    tests/test_torch_vae_windows.py;
  * the Qwen stack's forward with its row-parallel sites against one
    process (f32, 1e-5);
  * a tiny meshed engine (text2music at batch 2, split over dp at (2, 2); the
    cover switch; base-model CFG) against the same engine in one process
    within 2e-3 of the latents' peak, as tests/test_distributed_multiproc.py
    holds the JAX package's meshed engine.
"""

import dataclasses
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from acestep_tpu.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu.models import vae as jvae
from acestep_tpu.parallel import mesh as jmesh_mod
from acestep_tpu.parallel import tp as jtp
from acestep_tpu_torch import config as tcfg
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.parallel import distributed, mesh as tmesh, sharding
from acestep_tpu_torch.parallel import lm_tp, tp as ttp
from acestep_tpu_torch.quant import QUANT_FORMATS, dequantize, quantize
from acestep_tpu_torch.settings import Settings
from tests.torch_parallel_worker import REPO, World

MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
ENGINE_DIT = DiTConfig(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=4, head_dim=16,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=8,
)
ENGINE_VAE = VAEConfig(audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
                       decoder_input_channels=8, downsampling_ratios=(2, 4, 4),
                       channel_multiples=(1, 2, 4))
ENGINE_TEXT = QwenConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, num_key_value_heads=2, intermediate_size=64,
                         head_dim=16)
QWEN_TP = QwenConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=8, num_key_value_heads=4, intermediate_size=128,
                     head_dim=16)
HOP = 8                        # the stand-in decoder's samples a frame
DECODE_T, DECODE_CHUNK = 44, 8
DECODE_WB = {2: 1, 4: 3}       # window batch by world size
GLOBAL_LOCALS = {2: [2, 1], 4: [4, 2, 1]}   # LOCAL_WORLD_SIZE for global_mesh
AMP = 4.0                      # the stand-in's peak passes 0.99: the segments rescale


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _fake_mesh(dp, tp, rank=0):
    """A mesh of no process group: what the layout functions read of it."""
    g = tmesh.Group(list(range(tp)), rank % tp, None, "gloo", torch.device("cpu"))
    return tmesh.Mesh(dp, tp, rank, g, g, g, "gloo", torch.device("cpu"))


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_tier_table_matches_jax():
    for n in range(1, 41):
        assert dataclasses.asdict(tmesh.tier_for(n)) == dataclasses.asdict(jmesh_mod.tier_for(n))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_local_cfg_matches_jax(tp):
    got = ttp.local_cfg(_port(ENGINE_DIT), tp)
    assert dataclasses.asdict(got) == dataclasses.asdict(jtp.local_cfg(ENGINE_DIT, tp))
    with pytest.raises(ValueError):
        ttp.local_cfg(_port(ENGINE_DIT), 3)


@pytest.mark.parametrize("fmt", QUANT_FORMATS)
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_round_trip(fmt, tp):
    """Column shards concatenated along N, and row shards along K, dequantize
    to the whole weight bit for bit."""
    k, n = 1024, 96
    w = quantize(torch.from_numpy(np.random.default_rng(tp).standard_normal((k, n))
                                  .astype(np.float32) * 0.02), fmt)
    whole = dequantize(w, torch.float32)
    cols = [sharding.shard_weight(w, "col", tp, r) for r in range(tp)]
    rows = [sharding.shard_weight(w, "row", tp, r) for r in range(tp)]
    assert all(c.shape == (k, n // tp) for c in cols)
    assert all(r.shape == (k // tp, n) for r in rows)
    assert torch.equal(torch.cat([dequantize(c, torch.float32) for c in cols], 1), whole)
    assert torch.equal(torch.cat([dequantize(r, torch.float32) for r in rows], 0), whole)


@pytest.mark.parametrize("fmt,k,tp", [("q4_0", 256, 2), ("q4_k", 512, 4), ("q6_k", 512, 4),
                                      ("q8_0", 96, 2)])
def test_row_cut_that_splits_a_block_stays_whole(fmt, k, tp):
    """A K cut inside a block stays whole (the replicate rule); at q4_0 K 256
    over 2 every field's rows divide, so a field-wise cut (the JAX package's
    divisibility test) would split the fold-256 nibbles."""
    w = quantize(torch.ones((k, 64)) * 0.01, fmt)
    assert sharding.shard_weight(w, "row", tp, 0) is w
    tree = sharding.shard_params({"o_proj": {"kernel": w}}, _fake_mesh(1, tp))
    assert tree["o_proj"]["kernel"] is w
    with pytest.raises(ValueError):
        lm_tp._validate_row_parallel("o_proj", w, tp)


def test_shard_params_layout():
    """q/k/v/gate/up cut along N, o/down along K, the rest whole; a column
    width the tp size does not divide raises."""
    rng = np.random.default_rng(0)
    tree = {n: {"kernel": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))}
            for n in ("q_proj", "o_proj", "gate_proj", "down_proj", "proj_in")}
    tree["q_norm"] = torch.ones(16)
    got = sharding.shard_params(tree, _fake_mesh(2, 2, rank=3))
    assert torch.equal(got["q_proj"]["kernel"], tree["q_proj"]["kernel"][:, 16:])
    assert torch.equal(got["gate_proj"]["kernel"], tree["gate_proj"]["kernel"][:, 16:])
    assert torch.equal(got["o_proj"]["kernel"], tree["o_proj"]["kernel"][32:])
    assert torch.equal(got["down_proj"]["kernel"], tree["down_proj"]["kernel"][32:])
    assert got["proj_in"]["kernel"] is tree["proj_in"]["kernel"]
    assert got["q_norm"] is tree["q_norm"]
    with pytest.raises(ValueError):
        sharding.shard_params({"q_proj": {"kernel": torch.ones(8, 6)}}, _fake_mesh(1, 4))


def test_bad_tp_raises():
    """tests/test_lm_tp.py's TestValidation: heads 6 / 3 over tp 4."""
    cfg = tcfg.QwenConfig(vocab_size=160, hidden_size=64, num_hidden_layers=1,
                          num_attention_heads=6, num_key_value_heads=3, intermediate_size=96,
                          head_dim=16)
    from acestep_tpu_torch.models import qwen

    p = qwen.stack_params(qwen.init_params(cfg, device="cpu", seed=0, dtype=torch.float32))
    with pytest.raises(ValueError):
        lm_tp.prepare_tp_params(p, cfg, _fake_mesh(1, 4))


@pytest.mark.parametrize("n, local, shape", [(2, 2, (1, 2)), (2, 1, (2, 1)), (4, 4, (1, 4)),
                                             (4, 2, (2, 2)), (4, 1, (4, 1)), (8, 8, (2, 4)),
                                             (8, 2, (4, 2)), (16, 4, (4, 4))])
def test_mesh_shape_clamps_tp_to_a_host(n, local, shape):
    """The tier's tp clamped to one host's ranks and dp the rest, in the mesh
    and in the settings the CLI builds its mesh from."""
    assert tmesh.mesh_shape(n, local) == shape
    s = Settings.load(env_file="/nonexistent", n_devices=n, local_devices=local)
    assert (s.dp, s.tp) == shape and s.sources["tp"] == "topology"
    with pytest.raises(ValueError):
        Settings.load(env_file="/nonexistent", n_devices=n, tp=1)


def test_initialize_over_nccl_without_the_card_raises(monkeypatch, tmp_path):
    """NCCL takes the rank's card, cuda:LOCAL_RANK, as its current device
    before it joins: a card that does not exist raises, with no fallback to
    gloo or the CPU, and no process group is formed."""
    monkeypatch.setenv("LOCAL_RANK", "64")
    with pytest.raises(RuntimeError, match="cuda:64 does not exist"):
        distributed.initialize("nccl", "file://" + str(tmp_path / "store"), 1, 0)
    assert not torch.distributed.is_initialized()


def test_initialize_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_primary()
    assert distributed.topology()[0] == 1




# ---------------------------------------------------------------------------
# spawned processes
# ---------------------------------------------------------------------------

def _start_bad_address():
    """A rank that cannot reach its store (a closed port on this host), in a
    process of its own: ``initialize`` must raise, not fall back to one
    process.  The caller collects it with ``communicate``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from acestep_tpu_torch.parallel import distributed\n"
            "try:\n"
            "    distributed.initialize('gloo', 'tcp://127.0.0.1:%d', 2, 1, timeout_s=2)\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', e); sys.exit(0)\n"
            "sys.exit(1)\n") % (REPO, port)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _jmesh(dp, tp):
    return JMesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))


def _jax_standin(params, cfg, z):
    y = z[..., :2]
    y = y + 0.5 * jnp.pad(y, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    return jnp.repeat(y, HOP, axis=1)


def _jax_decodes(lat, mesh, wb):
    """The JAX package's meshed decodes, by the worker's output names.  The
    stand-in reads no parameters: the jitted functions are called with None
    for them, a tree no real call passes, so their compiled stand-in is never
    reused by another caller."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvae, "decode", _jax_standin)
        i16, scale = jvae.fused_tiled_decode_int16(
            None, ENGINE_VAE, jnp.asarray(lat), chunk_frames=DECODE_CHUNK, max_window_batch=wb,
            mesh=mesh)
        out[f"tiled_wb{wb}"], out[f"tiled_scale_wb{wb}"] = np.asarray(i16), float(scale)
        windows = jvae._window_plan(lat.shape[1], DECODE_CHUNK, None)
        for j, (lo, hi, rel) in enumerate(tpipeline.segment_windows(windows, DECODE_CHUNK)):
            i16, scale = jvae.fused_decode_windows_int16(
                None, ENGINE_VAE, jnp.asarray(lat[:1, lo:hi]), tuple(rel), max_window_batch=wb,
                mesh=mesh)
            out[f"seg{j}_wb{wb}"], out[f"seg{j}_scale_wb{wb}"] = np.asarray(i16), float(scale)
    return out


def _requests():
    rng = np.random.default_rng(7)
    style = rng.integers(0, 256, (1, 6))
    src = rng.standard_normal((1, 250, 8)).astype(np.float32)
    refer = rng.standard_normal((1, 1, 20, 8)).astype(np.float32)
    return {
        "batch2": (dict(duration_s=10.0, batch_size=2, style_token_ids=np.tile(style, (2, 1)),
                        lyric_token_ids=rng.integers(0, 256, (2, 9)), seeds=[3, 4]), None),
        "cover": (dict(duration_s=10.0, style_token_ids=style, task="cover", src_latents=src,
                       refer_latents=refer, audio_cover_strength=0.5, seeds=[5]), None),
        "cfg": (dict(duration_s=10.0, style_token_ids=style, guidance_scale=3.0, infer_steps=6,
                     seeds=[6]), None),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: (reference, each rank's outputs).  The worlds are spawned
    first and the references computed while they run."""
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, DECODE_T, 8)).astype(np.float32) * AMP
    lat[:, 30:34] *= 3.0
    engine_kw = dict(seed=1, quant=None, dit_cfg=dataclasses.asdict(ENGINE_DIT),
                     vae_cfg=dataclasses.asdict(ENGINE_VAE),
                     text_cfg=dataclasses.asdict(ENGINE_TEXT))
    cases, parts = {w: {} for w in MESHES}, {}
    ids = rng.integers(0, QWEN_TP.vocab_size, (2, 9))
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    for world, meshes in MESHES.items():
        for dp, tp in meshes:
            tag = f"{dp}x{tp}"
            parts[tag] = (rng.standard_normal((tp, 512)) * np.exp(
                rng.standard_normal((tp, 512)) * 3)).astype(np.float32)
            cases[world][f"reduce_{tag}"] = dict(kind="reduce", mesh=(dp, tp),
                                                 parts=parts[tag], x=x, w=w)
            cases[world][f"engine_{tag}"] = dict(kind="engine", mesh=(dp, tp),
                                                 requests=_requests(), **engine_kw)
            cases[world][f"qwen_{tag}"] = dict(kind="qwen", mesh=(dp, tp), seed=2, ids=ids,
                                               cfg=dataclasses.asdict(QWEN_TP))
    for world, meshes in MESHES.items():
        dp, tp = meshes[0]
        cases[world][f"global_{world}"] = dict(kind="global", mesh=(dp, tp),
                                               locals=GLOBAL_LOCALS[world])
        cases[world][f"decode_{world}"] = dict(
            kind="decode", mesh=(dp, tp), hop=HOP, latents=lat, chunk=DECODE_CHUNK,
            wbs=[DECODE_WB[world]], vae_cfg=dataclasses.asdict(ENGINE_VAE))
    worlds = {wd: World(str(tmp_path_factory.mktemp(f"world{wd}")), wd, MESHES[wd], cases[wd])
              for wd in MESHES}
    bad_address = _start_bad_address()

    refs = {}
    for tag, p in parts.items():
        tp = int(tag[-1])
        pb = jnp.asarray(p, jnp.bfloat16)
        f = jax.jit(shard_map(lambda v: jax.lax.psum(v[0], "tp")[None], mesh=_jmesh(1, tp),
                              in_specs=P("tp", None), out_specs=P("tp", None),
                              check_rep=False))
        refs[f"reduce_{tag}"] = np.asarray(f(pb)).astype(np.float32)[0]
        refs[f"parts_{tag}"] = p
    refs["matmul"] = x @ w
    for world in MESHES:
        refs[f"decode_{world}"] = _jax_decodes(lat, _jmesh(1, world), DECODE_WB[world])
    from acestep_tpu_torch.models import qwen

    qp = qwen.stack_params(qwen.init_params(_port(QWEN_TP), device="cpu", seed=2,
                                            dtype=torch.float32))
    refs["qwen"] = qwen.forward(qp, _port(QWEN_TP), torch.from_numpy(ids)).numpy()
    single = tpipeline.build_random_engine(
        device="cpu", quant=None, seed=1, dit_cfg=_port(ENGINE_DIT), vae_cfg=_port(ENGINE_VAE),
        text_cfg=_port(ENGINE_TEXT))
    for name, (req, _) in _requests().items():
        res = single.generate(tpipeline.GenerationRequest(**req))
        refs[f"engine/{name}"] = (res.latents, res.audio_i16)
    ranks = {wd: worlds[wd].wait() for wd in MESHES}
    refs["bad_address"] = bad_address.communicate(timeout=120)
    return refs, {name: ranks[wd] for wd in MESHES for name in cases[wd]}


def _outputs(ranks, name, key):
    outs = [r[f"{name}/{key}"] for r in ranks[name]]
    for r, o in enumerate(outs[1:], 1):
        np.testing.assert_array_equal(o, outs[0], err_msg=f"{name}/{key}: rank {r} != rank 0")
    return outs[0]


@pytest.mark.parametrize("world, local", [(w, n) for w in MESHES for n in GLOBAL_LOCALS[w]])
def test_global_mesh_clamps_tp_to_the_host(runs, world, local):
    """``global_mesh`` over a world whose hosts hold ``local`` ranks each:
    tp the tier's clamped to ``local``, dp the rest, ranks dp-major."""
    _, ranks = runs
    dp, tp = tmesh.mesh_shape(world, local)
    assert tp == min(tmesh.tier_for(world).tp, local) and dp * tp == world
    for r, out in enumerate(ranks[f"global_{world}"]):
        np.testing.assert_array_equal(out[f"global_{world}/local{local}"],
                                      [dp, tp, r // tp, r % tp])


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
def test_all_reduce_matches_jax_psum(runs, tag):
    refs, ranks = runs
    np.testing.assert_array_equal(_outputs(ranks, f"reduce_{tag}", "sum"), refs[f"reduce_{tag}"])


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
def test_broadcast_from_the_last_rank(runs, tag):
    refs, ranks = runs
    got = _outputs(ranks, f"reduce_{tag}", "broadcast")
    want = refs[f"parts_{tag}"][-1]
    np.testing.assert_array_equal(got, want.astype(jnp.bfloat16).astype(np.float32))


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
def test_ring_matmul_matches_all_reduce(runs, tag):
    refs, ranks = runs
    ring = _outputs(ranks, f"reduce_{tag}", "ring")
    ar = _outputs(ranks, f"reduce_{tag}", "allreduce")
    np.testing.assert_allclose(ring, ar, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ar, refs["matmul"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
def test_qwen_forward_tensor_parallel(runs, tag):
    """The Qwen stack with row-parallel o_proj and down_proj (the JAX
    qwen.py:106-135 sites) against one process, f32 within 1e-5."""
    refs, ranks = runs
    np.testing.assert_allclose(_outputs(ranks, f"qwen_{tag}", "hidden"), refs["qwen"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_window_sharded_decode_equals_jax(runs, world):
    refs, ranks = runs
    ref = refs[f"decode_{world}"]
    for key, want in ref.items():
        np.testing.assert_array_equal(_outputs(ranks, f"decode_{world}", key), want,
                                      err_msg=key)


@pytest.mark.parametrize("tag", ["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("request_name", ["batch2", "cover", "cfg"])
def test_meshed_engine_matches_one_process(runs, tag, request_name):
    """Latents within the JAX multi-process test's 2e-3, and the waveform
    against the one process's waveform."""
    refs, ranks = runs
    lat_ref, audio_ref = refs[f"engine/{request_name}"]
    lat = _outputs(ranks, f"engine_{tag}", f"{request_name}_latents")
    audio = _outputs(ranks, f"engine_{tag}", f"{request_name}_audio")
    assert np.isfinite(lat).all() and lat.shape == lat_ref.shape
    err = np.abs(lat - lat_ref).max() / (np.abs(lat_ref).max() + 1e-9)
    assert err < 2e-3, f"meshed engine {tag} diverges: rel={err:.2e}"
    assert audio.shape == audio_ref.shape and audio.dtype == np.int16
    # the waveform at the port's whole-request gate (chip_smoke.py's Q8_0 gate)
    a, b = audio.astype(np.float64).ravel(), audio_ref.astype(np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    snr = 10 * np.log10((b @ b) / max(((a - b) @ (a - b)), 1e-30))
    assert cos >= 0.999 and snr >= 26.0, f"meshed audio {tag}: cosine {cos}, SNR {snr} dB"


def test_initialize_raises_on_a_bad_address(runs):
    refs, _ = runs
    out, _ = refs["bad_address"]
    assert "RAISED" in out, out
