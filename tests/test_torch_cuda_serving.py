"""The serving slice's device work on the card: the LoRA merge (dequantize,
add the delta, requantize, on the card) against the same merge on the CPU,
and the alignment probe (its linears on the dequant-matmul kernel) against
its plain version on the CPU.

Every test needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py -q

Bounds: the quantizers and the merge are elementwise f32 with true
divisions and the delta summed in rank order (quant/formats.py,
training/lora.py), so the card's quantized fields equal the CPU's bit for
bit.  The probe's maps (probabilities of order 1 / Lc) are held to 2e-3
absolute, the bound of its CPU parity test against the JAX package
(tests/test_torch_alignment.py), and its score to 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch import alignment
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.ops.cuda import qmm
from acestep_tpu_torch.quant import QuantTensor, quantize
from acestep_tpu_torch.training import lora
from acestep_tpu_torch.weights import tree_to

MAP_ATOL = 2e-3
SCORE_RTOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q6_k"])
def test_quantizers_card_equal_cpu(dev, fmt):
    """The port's quantizers give the same fields on the card as on the CPU
    (and so as the JAX package's numpy ones): a division by a Python number
    on the card would be a multiplication by its reciprocal and part in the
    last bit (found with the LoRA merge: q8_0 and q4_k fields differed)."""
    g = torch.Generator().manual_seed(11)
    w = torch.randn(2048, 1536, generator=g) * 0.02
    w[:256, :8] = 0.0                                   # zero blocks
    w[256:512, 8:16] *= 1e-6                            # tiny scales
    want = quantize(w, fmt)
    got = quantize(w.to(dev), fmt)
    for f, a in want.fields().items():
        assert torch.equal(getattr(got, f).cpu(), a), f


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q6_k"])
def test_lora_merge_card_equals_cpu(dev, fmt):
    g = torch.Generator().manual_seed(3)
    shapes = {"q_proj": (2048, 2048), "k_proj": (2048, 1024), "down_proj": (6144, 2048)}
    base = {"layers": [{n: {"kernel": quantize(torch.randn(k, m, generator=g) * 0.02, fmt)}
                        for n, (k, m) in shapes.items()}]}
    adapter = {"layers": [{n: {"kernel": {"a": torch.randn(k, 16, generator=g) / 16,
                                          "b": torch.randn(16, m, generator=g) * 0.01}}
                           for n, (k, m) in shapes.items()}]}
    want = lora.apply_lora(base, adapter, alpha=16.0)
    got = lora.apply_lora(tree_to(base, dev), tree_to(adapter, dev), alpha=16.0)
    for n in shapes:
        w, c = want["layers"][0][n]["kernel"], got["layers"][0][n]["kernel"]
        assert isinstance(c, QuantTensor) and c.data.is_cuda and c.fmt == fmt
        for f, a in w.fields().items():
            assert torch.equal(getattr(c, f).cpu(), a), (n, f)
        # the merge moved the weight
        assert not torch.equal(c.data.cpu(), base["layers"][0][n]["kernel"].data)


SMALL_DIT = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                      in_channels=24, audio_acoustic_hidden_dim=8, sliding_window=8,
                      text_hidden_dim=128, num_lyric_encoder_hidden_layers=1)
SMALL_TEXT = QwenConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, num_key_value_heads=2, intermediate_size=256,
                        head_dim=64)
SMALL_VAE = VAEConfig(encoder_hidden_size=16, decoder_channels=128, decoder_input_channels=8,
                      downsampling_ratios=(2, 2, 2), channel_multiples=(1, 2, 4))


@pytest.mark.parametrize("duration", [10.0, 30.0])
def test_alignment_probe_card_vs_cpu(dev, duration):
    cpu = tpipeline.build_random_engine(device="cpu", quant="q8_0", seed=3, dit_cfg=SMALL_DIT,
                                        vae_cfg=SMALL_VAE, text_cfg=SMALL_TEXT)
    gpu = tpipeline.AceStepEngine(tree_to(cpu.dit_params, dev), SMALL_DIT,
                                  tree_to(cpu.vae_params, dev), SMALL_VAE,
                                  tree_to(cpu.text_params, dev), SMALL_TEXT, device=dev)
    rng = np.random.default_rng(int(duration))
    t_valid = tpipeline.frames_for_duration(duration)
    lat = rng.standard_normal((1, t_valid, 8)).astype(np.float32)
    req = tpipeline.GenerationRequest(duration_s=duration, seeds=[1],
                                      style_token_ids=rng.integers(0, 512, (1, 20)),
                                      lyric_token_ids=rng.integers(0, 512, (1, 60)))
    eps = torch.randn((1, tpipeline.bucket_frames(t_valid), 8),
                      generator=torch.Generator().manual_seed(0))
    want, n = cpu.lyric_attention_map(lat, req, eps)
    before = qmm.KERNELS["q8_0"].launches
    got, n_gpu = gpu.lyric_attention_map(lat, req, eps)
    assert qmm.KERNELS["q8_0"].launches > before
    assert n == n_gpu == 60 and got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= MAP_ATOL, err
    s_want, s_got = alignment.alignment_score(want, n), alignment.alignment_score(got, n)
    assert abs(s_got - s_want) <= SCORE_RTOL * abs(s_want), (s_got, s_want)
    stamps = alignment.token_timestamps(got, n, SMALL_DIT.patch_size / 25.0)
    assert (np.diff(stamps) >= 0).all()
