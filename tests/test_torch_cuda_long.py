"""Long songs and merged batches on the card: blocked self-attention against
dense masked attention, a segmented VAE decode against a one-pass one, and a
two-item merged batch against its items served alone.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_long.py -q

Bounds: banded attention is dense attention under the sliding mask summed in
another order, held to one bf16 step of the valid rows' peak (2^-7); flash
rounds its unnormalised block probabilities to bf16 where dense attention
rounds the normalised ones, held to two (2^-6); on the CPU at these shapes
they part by 5.8e-4 and 5.6e-3 (tests/test_torch_blocked_attention.py holds
both to the JAX functions).  A reconciled segment equals the one-pass decode
where it was decoded at the global scale and is within one int16 step where it
was re-quantized.  A merged item and the same request alone, given the same
noise, meet the Q8_0 gate (cosine >= 0.999, SNR >= 26 dB) on latents and on
audio up to one decode overlap before the item's end; on the CPU they are
equal (tests/test_torch_batcher.py).
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch import pipeline
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.models import vae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops import blocked_attention as ba
from acestep_tpu_torch.ops.cuda import vae_resunit as vru
from acestep_tpu_torch.ops.nn import attention, make_attention_mask
from acestep_tpu_torch.serving.batcher import merge_requests

BANDED_REL = 2.0 ** -7
FLASH_REL = 2.0 ** -6
SMALL_DIT = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                      in_channels=24, audio_acoustic_hidden_dim=8, sliding_window=8,
                      text_hidden_dim=128, num_lyric_encoder_hidden_layers=1)
SMALL_TEXT = QwenConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=2, intermediate_size=256,
                        head_dim=64)
SMALL_VAE = VAEConfig(encoder_hidden_size=16, decoder_channels=128, decoder_input_channels=8,
                      downsampling_ratios=(2, 2, 2), channel_multiples=(1, 2, 4))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _valid_rel(got, ref, n_pad):
    t = ref.shape[2]
    d = (got.float() - ref.float()).abs()
    err = max(float(d[0].max()), float(d[1, :, :t - n_pad].max()))
    peak = max(float(ref[0].float().abs().max()), float(ref[1, :, :t - n_pad].float().abs().max()))
    return err / peak


def test_blocked_vs_dense_attention(dev):
    t, n_pad, window = 1536, 300, 128
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 16, t, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((2, 8, t, 128), generator=g, device=dev).bfloat16() for _ in range(2))
    valid = torch.ones((2, t), dtype=torch.int32, device=dev)
    valid[1, t - n_pad:] = 0
    band_ref = attention(q, k, v, make_attention_mask(t, t, kv_valid=valid,
                                                      sliding_window=window))
    full_ref = attention(q, k, v, make_attention_mask(t, t, kv_valid=valid))
    assert _valid_rel(ba.banded_attention(q, k, v, window, valid), band_ref, n_pad) <= BANDED_REL
    assert _valid_rel(ba.flash_attention(q, k, v, valid), full_ref, n_pad) <= FLASH_REL
    # a band one wider is another function
    assert _valid_rel(ba.banded_attention(q, k, v, window + 1, valid), band_ref, n_pad) \
        > BANDED_REL


@pytest.mark.parametrize("loud", [False, True])
def test_segment_round_trip(dev, loud):
    params = RandomInit(dev, 7, None).vae(SMALL_VAE)
    lat = torch.randn((1, 600, 8), generator=torch.Generator(device=dev).manual_seed(8),
                      device=dev) * (2.0 if loud else 0.002)
    chunk = 64
    plan = pipeline.segment_windows(vae._window_plan(600, chunk, None), chunk)
    assert len(plan) == 3
    launches = vru.TRIO.launches
    fetched = []
    for lo, hi, rel in plan:
        i16, s = vae.fused_decode_windows_int16(params, SMALL_VAE, lat[:, lo:hi], rel, 4)
        fetched.append((i16.cpu().numpy(), float(s)))
    assert vru.TRIO.launches > launches
    scales = {s for _, s in fetched}
    # quiet: every segment at full scale; loud: each at its own
    assert (scales == {32767.0}) != loud and (len(scales) > 1) == loud
    segments, scale = pipeline.reconcile_segments(fetched, 2)
    whole, whole_scale = vae.fused_tiled_decode_int16(params, SMALL_VAE, lat,
                                                      chunk_frames=chunk, max_window_batch=4)
    whole = whole.cpu().numpy().reshape(1, -1, 2)
    assert float(whole_scale) == scale
    at = 0
    for (_, s_g), seg in zip(fetched, segments):
        diff = np.abs(seg.astype(np.int32) - whole[:, at:at + seg.shape[1]].astype(np.int32))
        at += seg.shape[1]
        assert diff.max() <= (0 if s_g == scale else 1)
    assert at == whole.shape[1] == 600 * SMALL_VAE.hop_length


def _gate(ref, got):
    ref, got = ref.ravel().astype(np.float64), got.ravel().astype(np.float64)
    cos = ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got))
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))
    return cos, snr


def test_merged_item_vs_solo(dev):
    eng = pipeline.build_random_engine(device=dev, quant="q8_0", seed=3, dit_cfg=SMALL_DIT,
                                       vae_cfg=SMALL_VAE, text_cfg=SMALL_TEXT)
    rng = np.random.default_rng(1)
    style = rng.integers(0, 512, (1, 20))
    solo = pipeline.GenerationRequest(duration_s=30.0, style_token_ids=style, seeds=[2])
    merged = merge_requests([solo, pipeline.GenerationRequest(
        duration_s=60.0, style_token_ids=style, seeds=[4])])
    noise = torch.randn((2, 1536, 8), generator=torch.Generator(device=dev).manual_seed(11),
                        device=dev)
    res_m = eng.generate(merged, noise=noise)
    res_s = eng.generate(solo, noise=noise[:1, :768])
    hop = SMALL_VAE.hop_length
    assert res_m.audio_lengths == [750 * hop, 1500 * hop]
    assert res_s.time_costs["vae_overlapped"] == 1.0
    for ref, got in ((res_s.latents[0], res_m.latents[0, :750]),
                     (res_s.audio[0, :(750 - 64) * hop], res_m.audio[0, :(750 - 64) * hop])):
        cos, snr = _gate(ref, got)
        assert cos >= 0.999 and snr >= 26.0, (cos, snr)
    # beside another partner in the same bucket (one set of shapes, so one set
    # of kernel orders) the item's latents are equal bit for bit
    other = merge_requests([solo, pipeline.GenerationRequest(
        duration_s=55.0, style_token_ids=rng.integers(0, 512, (1, 20)), seeds=[5])])
    res_o = eng.generate(other, noise=torch.cat([noise[:1], torch.randn(
        (1, 1536, 8), generator=torch.Generator(device=dev).manual_seed(12), device=dev)]))
    np.testing.assert_array_equal(res_o.latents[0, :750], res_m.latents[0, :750])
