"""Training on the card: the res kernels' backward (rows 7 and 8 inside
``vae_resunit.KernelGrad``) against autograd through their plain PyTorch
versions, the VAE decode's gradient card vs CPU, and one LoRA step and one full
step of a small DiT on the card against the same steps on the CPU.

Every test needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_training.py -q

Tolerances: the backward 1e-4 of each gradient's peak in f32 (the res
kernels' forward bound; the backward is the plain version's autograd on the
card, so only the forward's kernel differs); a train step card vs CPU 2e-2 of
the peak (bf16 compute: the cuBLAS and CPU products round differently, about a
bf16 step; measured in chip_smoke.py phase train_check).
"""

import numpy as np
import pytest
import torch

from acestep_tpu_torch import weights
from acestep_tpu_torch.config import DiTConfig, VAEConfig
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.models.stacking import unstack_layer_params
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru
from acestep_tpu_torch.training import flow_matching as tfm
from acestep_tpu_torch.training import lora as tlora
from acestep_tpu_torch.weights import tree_to

RESUNIT_TOL = 1e-4
STEP_TOL = 2e-2
SMALL = DiTConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                  num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
                  text_hidden_dim=128)

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


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def _grads(fn, x, units, w):
    leaves = [v for u in units for part in u.values() for v in part.values()]
    ins = [x.clone().requires_grad_()] + [v.requires_grad_() for v in leaves]
    out = fn(ins[0], units)
    gs = torch.autograd.grad((out * w).sum(), ins)
    for v in leaves:
        v.requires_grad_(False)
    return out.detach(), gs


@pytest.mark.parametrize("kind,c,length", [("unit", 256, 4000), ("unit", 128, 777),
                                           ("trio", 128, 16000), ("trio", 128, 333)])
def test_res_kernel_backward(dev, kind, c, length):
    units = ((_unit(c, 1, dev),) if kind == "unit"
             else tuple(_unit(c, s, dev) for s in range(3)))
    x = torch.randn((2, length, c), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    w = torch.randn_like(x)

    def kernel(xx, us):
        return tvru.fused_res_unit(us[0], xx, 3) if kind == "unit" else tvru.fused_res_trio(us, xx)

    def plain(xx, us):
        if kind == "unit":
            return tvru.res_unit_plain(xx, *tvru.unit_tensors(us[0]), 3)
        per = [tvru.unit_tensors(u) for u in us]
        return tvru.res_trio_plain(xx, *(torch.stack([p[i] for p in per]) for i in range(8)))

    counter = tvru.UNIT if kind == "unit" else tvru.TRIO
    n0 = counter.launches
    out, got = _grads(kernel, x, units, w)
    assert counter.launches == n0 + 1          # the forward took the kernel
    ref_out, ref = _grads(plain, x, units, w)
    assert _rel(out, ref_out) <= RESUNIT_TOL
    for g, r in zip(got, ref):
        assert _rel(g, r) <= RESUNIT_TOL


def test_vae_decode_gradient_card_vs_cpu(dev):
    cfg = VAEConfig(audio_channels=2, encoder_hidden_size=16, decoder_channels=128,
                    decoder_input_channels=64, downsampling_ratios=(2, 2, 2),
                    channel_multiples=(1, 2, 4))
    params = RandomInit(torch.device("cpu"), 0, None, dtype=torch.float32).vae(cfg)
    lat = torch.randn((1, 6, 64), generator=torch.Generator().manual_seed(1))
    grads = {}
    for d in ("cpu", "cuda"):
        p = tree_to(params, d)
        leaves = weights.tree_leaves(p["decoder"])
        ins = [lat.to(d).requires_grad_()] + [v.requires_grad_() for v in leaves]
        out = tvae.decode(p, cfg, ins[0])
        w = torch.linspace(-1, 1, out.numel(), device=d).reshape(out.shape)
        grads[d] = [g.cpu() for g in torch.autograd.grad((out * w).sum(), ins)]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, r) <= RESUNIT_TOL


def _batch(device):
    rng = np.random.default_rng(0)
    t = 50
    b = {"latents": rng.standard_normal((2, t, 64)).astype(np.float32),
         "context_latents": rng.standard_normal((2, t, 128)).astype(np.float32),
         "encoder_hidden_states": rng.standard_normal((2, 20, SMALL.hidden_size)).astype(
             np.float32),
         "encoder_attn_mask": np.ones((2, 20), np.int32),
         "loss_mask": np.ones((2, t), np.float32)}
    b["loss_mask"][1, -10:] = 0
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_train_step_card_vs_cpu(dev, mode):
    base = RandomInit(torch.device("cpu"), 0, None, dtype=torch.float32).dit(SMALL)
    base["layers"] = unstack_layer_params(base["layers"])
    g = torch.Generator().manual_seed(4)
    t, noise = tfm.draw(g, _batch("cpu")["latents"])
    # one adapter for both devices (CUDA and CPU generators draw differently)
    lora0 = tlora.init_lora(torch.Generator().manual_seed(0), base, rank=4)
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_to(base, d)
        opt = tfm.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=10)
        if mode == "lora":
            tree, step = tree_to(lora0, d), tlora.make_lora_train_step(p, SMALL, opt, alpha=4.0)
        else:
            tree, step = p, tfm.make_train_step(SMALL, opt)
        out[d] = step(tree, opt.init(tree), _batch(d), t.to(d), noise.to(d))
    loss_card, loss_cpu = float(out["cuda"][2]), float(out["cpu"][2])
    assert np.isfinite(loss_card) and abs(loss_card - loss_cpu) <= STEP_TOL * abs(loss_cpu)
    for a, b in zip(weights.tree_leaves(out["cuda"][1].mu), weights.tree_leaves(out["cpu"][1].mu)):
        assert _rel(a.cpu().float(), b.float()) <= STEP_TOL or float(b.abs().max()) == 0
