"""The quantization-quality tools on the card: train_quality_eval's VAE loss
and gradients (rows 7-8 forward inside ``vae_resunit.KernelGrad``) against
the CPU and its steps, eval_quant_pipeline's variants on the dequant-matmul kernels, the
ablation's format level through the q8_0 kernel, and the variants' quantized
trees drawn on the card against the same trees quantized on the CPU.

Every test needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_quality.py -q

Tolerances: the VAE's loss within 1e-4 relative (the res kernels' bound)
and each leaf's gradient within 2x the drift of the card's plain path (res
units as plain convs) against the CPU, never tighter than 1e-3 of the CPU
gradient's norm (f32 on both sides, yet this loss at its initial tree parts
the plain path's gradients from the CPU's by 7.0e-3 on its worst leaf, and
the kernels' by 5.5e-3, chip_smoke.py phase quality (c) on the H100: cuDNN's
f32 convs and the kernels' 3xTF32 products round otherwise than the
CPU's); the quantized trees bit for bit (the port's quantizers divide by
tensors on the weight's device, so the card's fields equal the CPU's); the
format-level matmul cosine above 0.999 (the JAX tool's verdict).
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch import ablate_quant_noise as aqn
from acestep_tpu_torch import eval_quant_pipeline as eqp
from acestep_tpu_torch import train_quality_eval as tqe
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.cuda import qmm
from acestep_tpu_torch.ops.cuda import vae_resunit as vru
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.weights import flatten, tree_to

pytestmark = pytest.mark.cuda

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
DRIFT_FACTOR = 2.0
# the half-scale VAE's encoder widths (128 and 256 channels: rows 8 and 7) on
# a small decoder
VAE = VAEConfig(encoder_hidden_size=128, decoder_channels=8, decoder_input_channels=64,
                downsampling_ratios=(2, 4, 4), channel_multiples=(1, 2, 4), sampling_rate=800)
DIT = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=4, head_dim=64, in_channels=192,
                audio_acoustic_hidden_dim=64, sliding_window=16, text_hidden_dim=64,
                num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1)
TEXT = QwenConfig(vocab_size=150000, hidden_size=64, num_hidden_layers=1,
                  num_attention_heads=2, num_key_value_heads=1, intermediate_size=128,
                  head_dim=32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_vae_loss_and_grads_card_vs_cpu(dev, monkeypatch):
    """The VAE's loss and gradients at one tree on the card (rows 7-8 inside
    KernelGrad) against the CPU, within DRIFT_FACTOR x the drift of the
    card's plain path (the res units as plain convs) against the CPU; then
    three steps on the card launch the kernels once a step each (the
    trajectory itself is not held: Adam's +-lr moves of nearly cancelling
    gradients part any two paths within a few steps of this steep loss, the
    plain path on the card too)."""
    p0 = RandomInit(torch.device("cpu"), tqe.VAE_SEED, None).vae(VAE)
    rng = np.random.default_rng(0)
    songs = np.stack([tqe.synth_song(rng) for _ in range(2)])
    batches = [tqe.crops(rng, songs, 2) for _ in range(3)]

    def grads(d):
        loss, _, got = tqe.vae_grads(tree_to(p0, d), VAE, torch.from_numpy(batches[0]).to(d))
        return float(loss), [g.cpu() for g in got]

    def drift(g):
        return max(float((a - b).norm() / b.norm()) for a, b in zip(g[1], cpu[1]))

    cpu, card = grads("cpu"), grads(dev)
    with monkeypatch.context() as m:
        m.setattr(vru, "UNIT_CHANNELS", ())
        m.setattr(vru, "TRIO_CHANNELS", ())
        plain = grads(dev)
    assert abs(card[0] - cpu[0]) <= LOSS_RTOL * abs(cpu[0]), (card[0], cpu[0])
    assert drift(card) <= max(DRIFT_FACTOR * drift(plain), GRAD_RTOL), (drift(card),
                                                                         drift(plain))
    opt = tqe.vae_optimizer(3)
    params = tree_to(p0, dev)
    state = opt.init(params)
    n_unit, n_trio = vru.UNIT.launches, vru.TRIO.launches
    for b in batches:
        params, state, loss, _ = tqe.vae_step(params, state, opt, VAE, torch.from_numpy(b).to(dev))
        assert np.isfinite(float(loss))
    assert vru.TRIO.launches - n_trio == 2 * 3 and vru.UNIT.launches - n_unit == 3 * 3


def test_eval_quant_variants_launch_their_kernels(dev, tmp_path):
    launched = {}

    def on_variant(name):
        launched[name] = {fmt: k.launches for fmt, k in qmm.KERNELS.items()}

    rows = eqp.evaluate(str(tmp_path), device=dev, cfgs=(DIT, VAE, TEXT), log=lambda m: None,
                        on_variant=on_variant)
    assert [r["variant"] for r in rows] == ["fp_bf16", *eqp.FORMATS]
    assert all(np.isfinite(v) for r in rows[1:] for v in r["metrics"].values())
    order = ["fp_bf16", *eqp.FORMATS]
    for prev, name in zip(order, order[1:]):
        assert launched[name][name] > launched[prev][name], name
    q8 = rows[1]["metrics"]
    assert q8["latent_cos"] > 0.99 and q8["cosine"] > 0.9


@pytest.mark.parametrize("fmt", eqp.FORMATS)
def test_quantized_tree_on_card_equals_cpu(dev, fmt):
    tree = eqp.unstacked(RandomInit(dev, 0, None).dit(DIT))
    got = flatten(eqp.quantized(tree, fmt))
    ref = flatten(eqp.quantized(tree_to(tree, "cpu"), fmt))
    assert sorted(got) == sorted(ref)
    n = 0
    for name, r in ref.items():
        g = got[name]
        if isinstance(r, QuantTensor):
            n += 1
            assert isinstance(g, QuantTensor) and g.fmt == r.fmt, name
            for f, a in r.fields().items():
                assert torch.equal(g.fields()[f].cpu(), a), (name, f)
    assert n > 0


def test_ablation_format_level_on_card(dev):
    n_q8 = qmm.KERNELS["q8_0"].launches
    rows = aqn.part_a(np.random.default_rng(0), dev)
    cpu = aqn.part_a(np.random.default_rng(0), torch.device("cpu"))
    assert qmm.KERNELS["q8_0"].launches == n_q8 + len(aqn.SHAPES)
    for (name, rc, rr, mc), (_, crc, crr, cmc) in zip(rows, cpu):
        assert rc == crc and rr == crr, name          # the same quantization
        assert mc > 0.999 and abs(mc - cmc) < 1e-5, (name, mc, cmc)
