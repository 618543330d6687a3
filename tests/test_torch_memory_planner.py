"""Port parity of the memory planner (acestep_tpu_torch.memory_planner) against
the JAX package's: ``plan_request`` field by field, exactly, over a grid of
batch x frames x device memory x parameter bytes at full width and at a small
config, which includes clamps of the batch, of the VAE chunk and of the window
batch; the activation and per-frame models; ``tree_bytes`` of the same
parameters in both packages; and the engine's admission cap.
"""

import dataclasses

import numpy as np
import pytest
import torch

from acestep_tpu import memory_planner as jmp
from acestep_tpu.config import DiTConfig, VAEConfig
from acestep_tpu_torch import memory_planner as tmp
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch import weights
from tests.test_pipeline import TINY_DIT, TINY_TEXT
from tests.test_torch_models import SLICE_VAE, jax_params, port_cfg, to_np

GiB = 1024 ** 3
CONFIGS = [(DiTConfig(), VAEConfig()), (TINY_DIT, SLICE_VAE)]
GRID = [(batch, frames, mem, params)
        for batch in (1, 3, 8)
        for frames in (250, 1500, 3000, 7500, 15000)
        for mem in (4 * GiB, 16 * GiB, 80 * GiB)
        for params in (GiB // 2, 3 * GiB)]


def _fields(plan):
    d = dataclasses.asdict(plan)
    d.pop("dit_qmm_backend", None)
    return d


@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_plan_request_matches_jax(ci):
    dit_cfg, vae_cfg = CONFIGS[ci]
    tdit_cfg, tvae_cfg = port_cfg(dit_cfg), port_cfg(vae_cfg)
    clamps = {"batch": 0, "chunk": 0, "window": 0}
    for batch, frames, mem, params in GRID:
        assert tmp.dit_activation_bytes(tdit_cfg, batch, frames) == \
            jmp.dit_activation_bytes(dit_cfg, batch, frames)
        ref = jmp.plan_request(dit_cfg, vae_cfg, params, batch, frames, hbm_bytes=mem)
        got = tmp.plan_request(tdit_cfg, tvae_cfg, params, batch, frames, device_bytes=mem)
        assert _fields(got) == _fields(ref), (batch, frames, mem, params)
        clamps["batch"] += got.max_batch < batch
        clamps["chunk"] += got.vae_chunk_frames < 512
        clamps["window"] += got.vae_window_batch < 4
    assert tmp.vae_decode_bytes_per_frame(tvae_cfg) == jmp.vae_decode_bytes_per_frame(vae_cfg)
    assert tmp.SAFETY_MARGIN == jmp.SAFETY_MARGIN
    if ci == 0:      # the full-width grid clamps each of the three
        assert all(clamps.values()), clamps


def test_tree_bytes_and_device_bytes():
    dp, _, vp = jax_params(seed=2)
    for tree in (dp, vp):
        assert tmp.tree_bytes(weights.from_jax_numpy(to_np(tree))) == jmp.tree_bytes(tree)
    assert tmp.detect_device_bytes("cpu") == jmp.DEFAULT_HBM == 16 * GiB


def test_engine_clamps_and_admits():
    eng = tpipeline.build_random_engine(device="cpu", seed=1, dit_cfg=port_cfg(TINY_DIT),
                                        vae_cfg=port_cfg(SLICE_VAE),
                                        text_cfg=port_cfg(TINY_TEXT))
    pb = tmp.tree_bytes(eng.dit_params) + tmp.tree_bytes(eng.vae_params)
    ref = jmp.plan_request(TINY_DIT, SLICE_VAE, pb, 64, 15104, hbm_bytes=16 * GiB)
    assert eng.max_batch_for_frames(15000) == max(1, ref.max_batch)
    # a request larger than the plan admits is clamped, with a warning
    eng.plan = lambda batch, frames: tmp.Plan(max_batch=1, vae_chunk_frames=512, fits=True,
                                              detail={})
    req = tpipeline.GenerationRequest(
        duration_s=10.0, batch_size=2, seeds=[1, 2],
        style_token_ids=np.random.default_rng(0).integers(0, TINY_TEXT.vocab_size, (1, 8)))
    with pytest.warns(UserWarning, match="clamped batch 2 -> 1"):
        res = eng.generate(req, noise=torch.zeros((1, 256, TINY_DIT.audio_acoustic_hidden_dim)))
    assert res.latents.shape[0] == 1 and res.audio_lengths == [250 * SLICE_VAE.hop_length]
