"""The VAE encoder's res kernels at the shapes the audio-in tasks launch,
against their plain PyTorch versions, on the card.

``encode_src_audio`` and ``encode_refer_audio`` encode in 128-frame windows of
32 overlap (a 64-frame stride): the first window holds 96 frames, the inner
ones 128, the last one what is left (60 frames of a 60 s source, 72 of a 40 s
clip, 78 of the 750-frame reference window).  At full width encoder blocks 0
and 1 run the trio kernel at 128 channels on L and L / 2 samples (L = frames x
1920), block 2 the unit kernel at 256 channels on L / 8, d = 1, 3, 9.

Every test needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_encode.py -q

Tolerance: 1e-4 in f32 (the res kernels' bound, tests/test_vae_resunit_fused.py:39).
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru
from acestep_tpu_torch.weights import tree_to

RESUNIT_TOL = 1e-4
HOP = 1920
WINDOWS = (96, 128, 60, 72, 78)             # latent frames of the encoder's windows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit(c, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, s=0.3):
        return torch.randn(shape, generator=g, device=dev) * s

    return {"snake1": {"alpha": r(c), "beta": r(c)},
            "conv1": {"w": r(7, c, c, s=0.05), "b": r(c, s=0.1)},
            "snake2": {"alpha": r(c), "beta": r(c)},
            "conv2": {"w": r(1, c, c, s=0.05), "b": r(c, s=0.1)}}


@pytest.mark.parametrize("frames", WINDOWS)
@pytest.mark.parametrize("block", [0, 1])
def test_encoder_trio_shapes(dev, frames, block):
    x = torch.randn((1, frames * HOP // 2 ** block, 128), device=dev) * 0.5
    ops = tvru.trio_operands(tuple(_unit(128, 40 + i, dev) for i in range(3)), dev)
    torch.testing.assert_close(tvru.launch_trio(x, ops), tvru.res_trio_plain(x, *ops.plain),
                               atol=RESUNIT_TOL, rtol=RESUNIT_TOL)


@pytest.mark.parametrize("frames", WINDOWS)
def test_encoder_unit_shapes(dev, frames):
    x = torch.randn((1, frames * HOP // 8, 256), device=dev) * 0.5
    for d in (1, 3, 9):
        ops = tvru.unit_operands(_unit(256, 50 + d, dev), dev)
        torch.testing.assert_close(tvru.launch_unit(x, ops, d),
                                   tvru.res_unit_plain(x, *ops.plain, d),
                                   atol=RESUNIT_TOL, rtol=RESUNIT_TOL)


def test_full_width_encode_window_card_vs_cpu(dev):
    """One inner window (128 frames) through the full-width random encoder:
    the card (trio and unit kernels, cuDNN f32 convs) against the CPU (plain
    versions), within 1e-4 of the peak; the encoder's kernels launched."""
    cfg = VAEConfig()
    params = RandomInit(torch.device("cpu"), 3, None).vae(cfg)
    audio = torch.randn((1, 128 * HOP, 2), generator=torch.Generator().manual_seed(4)) * 0.3
    ref = tvae.encode(params, cfg, audio)
    trio, unit = tvru.TRIO.launches, tvru.UNIT.launches
    got = tvae.encode(tree_to(params, dev), cfg, audio.to(dev)).cpu()
    assert tvru.TRIO.launches == trio + 2 and tvru.UNIT.launches == unit + 3
    assert got.shape == ref.shape == (1, 128, 64)
    torch.testing.assert_close(got, ref, atol=RESUNIT_TOL * float(ref.abs().max()), rtol=0)


def test_encode_src_audio_windows_on_the_card(dev):
    """A 10 s mono source through a small engine whose encoder has the full
    width's first blocks (128 and 256 channels): 4 windows (96, 128, 128 and
    90 frames), every one on the card's kernels; equal to the CPU's within
    1e-4 of the peak."""
    vae_cfg = VAEConfig(channel_multiples=(1, 2, 4, 4, 4))
    dit_cfg = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                        text_hidden_dim=128, num_lyric_encoder_hidden_layers=1,
                        num_timbre_encoder_hidden_layers=1)
    text_cfg = QwenConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=2, intermediate_size=256,
                          head_dim=64)
    cpu = tpipeline.build_random_engine(device="cpu", quant="q8_0", seed=1, dit_cfg=dit_cfg,
                                        vae_cfg=vae_cfg, text_cfg=text_cfg)
    gpu = tpipeline.AceStepEngine(tree_to(cpu.dit_params, dev), dit_cfg,
                                  tree_to(cpu.vae_params, dev), vae_cfg,
                                  tree_to(cpu.text_params, dev), text_cfg, device=dev)
    wave = np.random.default_rng(2).standard_normal(250 * HOP).astype(np.float32) * 0.3
    trio, unit = tvru.TRIO.launches, tvru.UNIT.launches
    got = gpu.encode_src_audio(wave)
    assert (tvru.TRIO.launches - trio, tvru.UNIT.launches - unit) == (2 * 4, 3 * 4)
    ref = cpu.encode_src_audio(wave)
    assert got.shape == ref.shape == (1, 250, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESUNIT_TOL * np.abs(ref).max())
