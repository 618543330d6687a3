"""Port parity of the whole text2music slice (acestep_tpu_torch.pipeline)
against the JAX package, on the CPU, plus the port's import boundary.

The slice: encode_condition (lyric + style) -> ODE ``sample_latents`` with the
same numpy noise -> ``fused_tiled_decode_int16``.  Gate: the int16 waveform
reaches cosine >= 0.999 and SNR >= 26 dB against the JAX chain (the Q8_0 gate
of docs/BENCHMARK.md:25-29, measured with acestep_tpu.eval_metrics).
"""

import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.models import vae as jvae
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, jax_params, port_cfg, to_np

REPO = pathlib.Path(__file__).resolve().parents[1]
GATE_COSINE = 0.999
GATE_SNR_DB = 26.0


def _request(rng, cls):
    return cls(
        duration_s=10.0,
        style_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 20)),
        lyric_token_ids=rng.integers(0, TINY_TEXT.vocab_size, (1, 40)),
        seeds=[1],
    )


def test_pack_sequences_matches_jax():
    rng = np.random.default_rng(0)
    h1 = rng.standard_normal((2, 5, 4)).astype(np.float32)
    m1 = np.array([[1, 0, 1, 1, 0], [0, 0, 1, 1, 1]], np.int32)
    h2 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    m2 = np.array([[0, 1, 1], [1, 1, 0]], np.int32)
    ref_h, ref_m = jpipeline.pack_sequences(
        [(jnp.asarray(h1), jnp.asarray(m1)), (jnp.asarray(h2), jnp.asarray(m2))])
    got_h, got_m = tpipeline.pack_sequences(
        [(torch.from_numpy(h1), torch.from_numpy(m1)), (torch.from_numpy(h2), torch.from_numpy(m2))])
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def test_whole_slice_int16_gate():
    dp, tp, vp = jax_params(seed=3)
    rng = np.random.default_rng(4)
    t_valid = jpipeline.frames_for_duration(10.0)
    t = jpipeline.bucket_frames(t_valid)
    noise = rng.standard_normal((1, t, TINY_DIT.audio_acoustic_hidden_dim)).astype(np.float32)

    # JAX chain: the engine's own condition/context build, then sampler + decode
    jeng = jpipeline.AceStepEngine(dp, TINY_DIT, vp, SLICE_VAE, tp, TINY_TEXT)
    jreq = _request(np.random.default_rng(5), jpipeline.GenerationRequest)
    enc, enc_mask = jeng.build_condition(jreq, 1)
    ctx = jeng.build_context_latents(jreq, 1, t, t_valid)
    attn_mask = (jnp.arange(t)[None, :] < t_valid).astype(jnp.int32)
    lat = jsampler.sample_latents(
        jeng.dit_params, TINY_DIT, jnp.asarray(noise), ctx, enc, enc_mask,
        jsampler.get_timestep_schedule(3.0), attn_mask=attn_mask, use_attn_mask=True)
    i16_ref, scale_ref = jvae.fused_tiled_decode_int16(vp, SLICE_VAE, lat[:, :t_valid],
                                                       chunk_frames=512)
    ref = np.asarray(i16_ref).reshape(1, -1, 2).astype(np.float32) / float(scale_ref)

    teng = tpipeline.AceStepEngine(
        weights.from_jax_numpy(to_np(dp)), port_cfg(TINY_DIT),
        weights.from_jax_numpy(to_np(vp)), port_cfg(SLICE_VAE),
        weights.from_jax_numpy(to_np(tp)), port_cfg(TINY_TEXT), device="cpu")
    res = teng.generate(_request(np.random.default_rng(5), tpipeline.GenerationRequest),
                        noise=torch.from_numpy(noise))

    assert res.audio_lengths == [t_valid * SLICE_VAE.hop_length]
    assert res.audio_i16.shape == (1, t_valid * SLICE_VAE.hop_length, 2)
    assert res.audio_i16.dtype == np.int16 and np.isfinite(res.audio_scale)
    assert set(res.time_costs) == {
        "condition_time_cost", "diffusion_time_cost", "diffusion_per_step_time_cost",
        "vae_compute_time_cost", "audio_fetch_time_cost", "vae_time_cost",
        "total_time_cost"}
    got = res.audio
    assert np.abs(ref).std() > 0
    cos = eval_metrics.cosine(ref, got)
    snr = eval_metrics.snr_db(ref, got)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)


def test_random_engine_on_cpu():
    rng = np.random.default_rng(6)
    eng = tpipeline.build_random_engine(device="cpu", seed=1, dit_cfg=port_cfg(TINY_DIT),
                                        vae_cfg=port_cfg(SLICE_VAE),
                                        text_cfg=port_cfg(TINY_TEXT))
    res = eng.generate(_request(rng, tpipeline.GenerationRequest))
    assert res.audio_i16.shape == (1, 250 * SLICE_VAE.hop_length, 2)
    assert res.audio_i16.std() > 0 and np.isfinite(res.audio_scale) and res.audio_scale > 0
    again = eng.generate(_request(np.random.default_rng(6), tpipeline.GenerationRequest))
    np.testing.assert_array_equal(again.audio_i16, res.audio_i16)


def test_entry_points_require_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.build_random_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.resolve_device("cuda")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = (sorted((REPO / "acestep_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + [REPO / "tools" / "time_vae_resunit.py", REPO / "tools" / "vae_resunit_errors.py",
                REPO / "tools" / "time_lm_kernels.py", REPO / "tools" / "time_dit_mega.py",
                REPO / "tests" / "test_torch_decode_mega_plan.py",
                REPO / "tests" / "test_torch_dit_mega_plan.py",
                REPO / "tests" / "torch_parallel_worker.py", REPO / "tools" / "tp_phase.py"]
             + sorted((REPO / "tests").glob("test_torch_cuda_*.py")))
    assert len(files) > 10
    names = {str(p.relative_to(REPO)) for p in files}
    for module in ("chip_smoke.py", "acestep_tpu_torch/lm_pipeline.py",
                   "acestep_tpu_torch/serving/lm.py", "acestep_tpu_torch/serving/kv_cache.py",
                   "acestep_tpu_torch/ops/cuda/decode_attn.py",
                   "acestep_tpu_torch/ops/cuda/decode_mega.py",
                   "acestep_tpu_torch/ops/cuda/dit_mega.py",
                   "acestep_tpu_torch/ops/cuda/qmm_int8.py",
                   "acestep_tpu_torch/models/random_init.py", "tools/time_lm_kernels.py",
                   "tests/test_torch_decode_mega_plan.py", "tools/time_dit_mega.py",
                   "tests/test_torch_dit_mega_plan.py", "acestep_tpu_torch/memory_planner.py",
                   "acestep_tpu_torch/serving/batcher.py",
                   "acestep_tpu_torch/ops/blocked_attention.py",
                   "tests/test_torch_cuda_long.py", "acestep_tpu_torch/constrained.py",
                   "acestep_tpu_torch/scoring.py", "acestep_tpu_torch/inference.py",
                   "acestep_tpu_torch/serving/launch.py", "acestep_tpu_torch/models/codec.py",
                   "acestep_tpu_torch/training/dataset_builder.py",
                   "tests/test_torch_cuda_encode.py", "acestep_tpu_torch/alignment.py",
                   "acestep_tpu_torch/lora_runtime.py", "acestep_tpu_torch/progress.py",
                   "acestep_tpu_torch/training/lora.py", "acestep_tpu_torch/utils/audio.py",
                   "acestep_tpu_torch/utils/flac.py", "acestep_tpu_torch/utils/mp3.py",
                   "acestep_tpu_torch/serving/api_server.py",
                   "acestep_tpu_torch/serving/openrouter_server.py",
                   "tests/test_torch_cuda_serving.py", "acestep_tpu_torch/cli.py",
                   "acestep_tpu_torch/settings.py", "acestep_tpu_torch/training/data.py",
                   "acestep_tpu_torch/training/flow_matching.py",
                   "acestep_tpu_torch/training/lokr.py", "acestep_tpu_torch/training/trainer.py",
                   "acestep_tpu_torch/serving/training_manager.py",
                   "acestep_tpu_torch/serving/dataset_manager.py",
                   "tests/test_torch_cuda_training.py",
                   "acestep_tpu_torch/parallel/__init__.py",
                   "acestep_tpu_torch/parallel/mesh.py",
                   "acestep_tpu_torch/parallel/distributed.py",
                   "acestep_tpu_torch/parallel/sharding.py",
                   "acestep_tpu_torch/parallel/collective_matmul.py",
                   "acestep_tpu_torch/parallel/tp.py", "acestep_tpu_torch/parallel/lm_tp.py",
                   "tests/torch_parallel_worker.py", "tests/test_torch_cuda_parallel.py",
                   "tools/tp_phase.py"):
        assert module in names, module
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "acestep_tpu"), (path, name)
