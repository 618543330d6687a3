"""Serving from a group of processes on the card (acestep_tpu_torch.parallel).

Every test here needs an NVIDIA GPU and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py -q

Ranks are spawned by tests/torch_parallel_worker.py: world 1 over NCCL and
world 2 over gloo with both ranks on cuda:0 (NCCL refuses two ranks on one
card; gloo stages its collectives through the host).  Each world runs a q8_0
DiT forward and an LM prefill plus one decode step (row 9 at the rank's KV
heads), drawn from seeds on the card, against the same in this process:

  * world 1: equal bit for bit (a group of one is the identity, and at tp 1
    the layout is the single process's);
  * world 2: every rank equal bit for bit, and within the bf16 bounds of the
    one-process result: the DiT at cosine >= 0.9995 and four bf16 steps at
    the peak (tests/test_torch_models.py), the logits within 2e-2 of their
    peak (the decode-attention kernels' bound, tests/test_torch_cuda_decode.py),
    their argmax equal.

Each world also takes two full fine-tune steps (``make_tp_train_step``) of an
f32 DiT drawn from a seed on the card, against ``make_train_step`` in this
process on the same inputs: at world 1 the losses and the tree equal bit for
bit; at world 2 every rank's tree equal, the update within
tests/test_torch_training.py's UPDATE_TOL (the norm of the difference of a
leaf's update over the norm of the one process's, the largest) and each loss
within its per-step bound (1e-3).

And the kernels at the shard shapes those worlds launch, against their plain
versions: the q8_0 dequant-matmul at N / 2 and K / 2 of the DiT's linears
(tests/test_torch_cuda_kernels.py's bound), decode attention at 8 query and 4
KV heads (2e-2, tests/test_torch_cuda_decode.py).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig
from acestep_tpu_torch.models import dit, qwen
from acestep_tpu_torch.ops.cuda import decode_attn as tattn
from acestep_tpu_torch.ops.cuda import qmm as tqmm
from acestep_tpu_torch.quant import quantize_q8_0, QuantTensor
from acestep_tpu_torch.serving import kv_cache as kvc
from acestep_tpu_torch.serving import lm as lm_serving

# by path: the card's machine runs this file without the repository's conftest
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_worker import CARD_TRAIN_OPT, World, card_dit, card_train  # noqa: E402

pytestmark = pytest.mark.cuda

CARD_DIT = DiTConfig(hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                     num_attention_heads=8, num_key_value_heads=4, head_dim=128,
                     in_channels=24, audio_acoustic_hidden_dim=8, sliding_window=16,
                     text_hidden_dim=128, num_lyric_encoder_hidden_layers=0,
                     num_timbre_encoder_hidden_layers=0)
CARD_LM = QwenConfig(vocab_size=4096, hidden_size=512, num_hidden_layers=2,
                     num_attention_heads=16, num_key_value_heads=8, intermediate_size=1024,
                     head_dim=128)
BF16_COS, BF16_REL_MAX = 0.9995, 4 * 2.0 ** -7
LOGIT_REL = 2e-2
UPDATE_TOL = 1.5 * 0.0517     # tests/test_torch_training.py's UPDATE_TOL
LOSS_RTOL = 1e-3
QMM_ATOL = QMM_RTOL = 1e-2
ATTN_TOL = 2e-2


class _OneProcess:
    """The DiT forward and the LM step in this process (one rank, no group)."""

    @staticmethod
    def dit(dev):
        from acestep_tpu_torch.parallel import mesh as pmesh

        g = pmesh.Group([0], 0, None, "gloo", dev)
        one = pmesh.Mesh(1, 1, 0, g, g, g, "gloo", dev)
        cfg, params, (hs, t, enc, ctx) = card_dit(dataclasses.asdict(CARD_DIT), one, 3)
        kv = dit.compute_all_cross_kv(params, cfg, dit.compute_condition(params, cfg, enc))
        return dit.forward(params, cfg, hs, t, t, ctx, kv).float().cpu().numpy()

    @staticmethod
    def lm(dev):
        p = lm_serving.fuse_serving_params(lm_serving.ensure_quantized_head(
            qwen.init_params(CARD_LM, device=dev, seed=5, quant="q8_0")))
        ids = torch.arange(5, 5 + 37, device=dev)[None]
        cache = kvc.init_cache(CARD_LM.num_hidden_layers, 1, CARD_LM.num_key_value_heads, 128,
                               CARD_LM.head_dim, device=dev)
        lens = torch.tensor([37], dtype=torch.int32, device=dev)
        logits, cache = lm_serving.prefill(p, CARD_LM, ids, lens, cache)
        logits, _ = lm_serving.decode_step(p, CARD_LM, cache, logits.argmax(-1),
                                           decode_mega="0", decode_attn="pallas")
        return logits.cpu().numpy()

    @staticmethod
    def train(dev):
        """(losses, the tree's leaves by name, the initial leaves) of two
        ``make_train_step`` steps."""
        from acestep_tpu_torch import weights
        from acestep_tpu_torch.training import flow_matching as fm

        cfg, tree, batch, draws = card_train(dataclasses.asdict(CARD_DIT), dev, 9)
        p0 = {n: v.cpu().numpy() for n, v in weights.flatten(tree).items()}
        opt = fm.make_optimizer(**CARD_TRAIN_OPT)
        state, step, losses = opt.init(tree), fm.make_train_step(cfg, opt), []
        for t, noise in draws:
            tree, state, loss = step(tree, state, batch, t, noise)
            losses.append(np.float32(loss.item()))
        return losses, {n: v.cpu().numpy() for n, v in weights.flatten(tree).items()}, p0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        mesh = (1, world)
        cases = {"dit": dict(kind="card_dit", mesh=mesh, cfg=dataclasses.asdict(CARD_DIT),
                             seed=3),
                 "lm": dict(kind="card_lm", mesh=mesh, cfg=dataclasses.asdict(CARD_LM),
                            seed=5),
                 "train": dict(kind="card_train", mesh=mesh, cfg=dataclasses.asdict(CARD_DIT),
                               seed=9)}
        out[world] = World(str(tmp_path_factory.mktemp(f"card{world}")), world, [mesh], cases,
                           timeout_s=300, backend=backend, device="cuda:0").wait()
    return {"dit": _OneProcess.dit(dev), "lm": _OneProcess.lm(dev),
            "train": _OneProcess.train(dev)}, out


def _same_on_every_rank(ranks, key):
    for r, o in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(o[key], ranks[0][key], err_msg=f"rank {r}")
    return ranks[0][key]


def test_world_one_over_nccl_equals_one_process(worlds):
    ref, out = worlds
    np.testing.assert_array_equal(out[1][0]["dit/out"], ref["dit"])
    np.testing.assert_array_equal(out[1][0]["lm/logits"], ref["lm"])


def test_world_one_train_step_over_nccl_equals_one_process(worlds):
    ref, out = worlds
    losses, tree, _ = ref["train"]
    assert [out[1][0][f"train/loss{i}"] for i in range(2)] == losses
    for name, leaf in tree.items():
        np.testing.assert_array_equal(out[1][0][f"train/param/{name}"], leaf, err_msg=name)


def test_world_two_train_step(worlds):
    ref, out = worlds
    losses, tree, p0 = ref["train"]
    for i, want in enumerate(losses):
        got = float(_same_on_every_rank(out[2], f"train/loss{i}"))
        assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want)), (i, got, want)
    worst = 0.0
    for name, leaf in tree.items():
        got = _same_on_every_rank(out[2], f"train/param/{name}").astype(np.float64)
        du = leaf.astype(np.float64) - p0[name]
        worst = max(worst, float(np.linalg.norm(got - p0[name] - du) / np.linalg.norm(du)))
    assert worst <= UPDATE_TOL, worst


def test_world_two_dit_forward(worlds):
    ref, out = worlds
    got = _same_on_every_rank(out[2], "dit/out").ravel()
    want = ref["dit"].ravel()
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert cos >= BF16_COS and rel <= BF16_REL_MAX, (cos, rel)


def test_world_two_lm_decode_step(worlds):
    ref, out = worlds
    got = _same_on_every_rank(out[2], "lm/logits")
    rel = float(np.abs(got - ref["lm"]).max() / np.abs(ref["lm"]).max())
    assert rel <= LOGIT_REL, rel
    assert (got.argmax(-1) == ref["lm"].argmax(-1)).all()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _q8(k, n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quantize_q8_0(torch.randn((k, n), generator=g, device=dev) * 0.05)
    return QuantTensor("q8_0", (k, n), qt.data, qt.scales.float())


# (M, K, N) of CARD_DIT's linears at tp 2 (batch 2 of 32 patch tokens; the
# condition 2 x 20): q and gate/up cut along N to 512, k/v to 256, o_proj and
# down_proj along K to 512 (N 512); the cross K/V at M 40
@pytest.mark.parametrize("m,k,n", [(64, 512, 512), (64, 512, 256), (40, 512, 256)])
def test_qmm_at_shard_shapes(dev, m, k, n):
    qt = _q8(k, n, m + k + n, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    got = tqmm._launch(x, qt, None, torch.bfloat16).float()
    ref = tqmm.qmm_plain(x, qt).float()
    assert torch.allclose(got, ref, atol=QMM_ATOL, rtol=QMM_RTOL)


@pytest.mark.parametrize("hq,hkv", [(8, 4), (4, 2)])
def test_decode_attention_at_shard_heads(dev, hq, hkv):
    g = torch.Generator(device=dev).manual_seed(hq)
    n_l, b, t_max = 2, 2, 128
    kq, ks = kvc.quantize_kv(torch.randn((n_l, b, hkv, t_max, 128), generator=g, device=dev))
    vq, vs = kvc.quantize_kv(torch.randn((n_l, b, hkv, t_max, 128), generator=g, device=dev))
    lens = torch.tensor([37, 100], dtype=torch.int32, device=dev)
    q, k, v = (torch.randn((b, h, 128), generator=g, device=dev).bfloat16()
               for h in (hq, hkv, hkv))
    assert tattn.takes(hq, hkv, 128, t_max)
    for li in range(n_l):
        got = tattn.decode_attention_int8_stacked(q, kq, ks, vq, vs, lens, li, k, v)
        ref = tattn.decode_attention_plain(q, kq, ks, vq, vs, lens, li, k, v)
        assert torch.allclose(got.float(), ref.float(), atol=ATTN_TOL, rtol=ATTN_TOL)

