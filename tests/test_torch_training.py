"""The port's flow-matching training (acestep_tpu_torch.training) against the
JAX package on the CPU, at the JAX training tests' tiny DiT (f32 params, bf16
compute).

Draws: ``jax.random`` cannot be reproduced, so every port step is given the
JAX step's own draws (its key split as flow_matching.py:43 splits it).

Tolerances (max |port - JAX| over max |JAX|, per leaf; derived from the JAX
package's own eager-vs-jitted spread on the same computation, measured on
this CPU):
  * loss and gradients, against jitted JAX: 1.5x the spread of 1.18e-2 (the
    bf16 products round differently once XLA fuses them); the port's error
    was 7.7e-3 against eager JAX and 1.18e-2 against jitted;
  * three full fine-tune steps, against jitted JAX: 1.5x the spread of 0.140
    (the same roundings, amplified by Adam where a gradient is tiny);
    measured 0.125 against eager and 0.143 against jitted;
  * the update of those steps (params minus the initial params), per leaf as
    the norm of the difference over the norm of JAX's update (a max would be
    dominated by the elements whose tiny gradient flips sign, where Adam
    moves by +-lr either way): 1.5x the spread of 0.0517; measured 0.0550
    against jitted and 0.0301 against eager.  This holds the optimizer on the
    norm leaves too, whose 1.0 dwarfs the 2e-2 update in the check above;
  * three LoRA or LoKr steps, against eager JAX: 1e-5 (the spreads were 0.099
    and 0.049; the port matched eager JAX to 1e-7 and 5e-7);
  * the optimizer alone on fixed gradients: 1e-6 of each leaf's peak (f32
    arithmetic in the same order; the global norm sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acestep_tpu.config import DiTConfig, VAEConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import vae as jvae
from acestep_tpu.ops.pallas import vae_resunit as jvru
from acestep_tpu.quant import quantize_jax
from acestep_tpu.training import flow_matching as jfm
from acestep_tpu.training import lokr as jlokr
from acestep_tpu.training import lora as jlora
from acestep_tpu_torch import weights
from acestep_tpu_torch.config import DiTConfig as TDiTConfig
from acestep_tpu_torch.config import VAEConfig as TVAEConfig
from acestep_tpu_torch.models import vae as tvae
from acestep_tpu_torch.ops.cuda import vae_resunit as tvru
from acestep_tpu_torch.sampler import SHIFT_TIMESTEPS
from acestep_tpu_torch.training import flow_matching as tfm
from acestep_tpu_torch.training import lokr as tlokr
from acestep_tpu_torch.training import lora as tlora
from tests.test_torch_models import _vae_params
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = DiTConfig(
    hidden_size=32, intermediate_size=64, num_hidden_layers=1,
    num_attention_heads=2, num_key_value_heads=2, head_dim=16,
    in_channels=12, audio_acoustic_hidden_dim=4, patch_size=2,
    sliding_window=4, text_hidden_dim=16,
    num_lyric_encoder_hidden_layers=0, num_timbre_encoder_hidden_layers=0,
    timbre_hidden_dim=4,
)
TTINY = TDiTConfig(**dataclasses.asdict(TINY))
B, T, LC = 2, 8, 3
GRAD_SPREAD = 0.0118     # loss and grads: jitted vs eager JAX, max relative error of a leaf
FULL_SPREAD = 0.140
FULL_TOL = 1.5 * FULL_SPREAD
UPDATE_SPREAD = 0.0517   # the full steps' update, jitted vs eager JAX, norm per leaf
UPDATE_TOL = 1.5 * UPDATE_SPREAD
ADAPTER_TOL = 1e-5
OPT_RTOL = 1e-6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    b = {"latents": rng.standard_normal((B, T, 4)).astype(np.float32),
         "context_latents": rng.standard_normal((B, T, 8)).astype(np.float32),
         "encoder_hidden_states": rng.standard_normal((B, LC, 32)).astype(np.float32),
         "encoder_attn_mask": np.array([[1, 1, 1], [1, 1, 0]], np.int32),
         "loss_mask": np.ones((B, T), np.float32)}
    b["loss_mask"][1, -3:] = 0.0        # item 2's last frames are not generated
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _draws(key, shape=(B, T, 4)):
    """The JAX loss's draws for ``key`` (flow_matching.py:43-45) as tensors."""
    k_t, k_n = jax.random.split(key)
    t = np.asarray(jfm.sample_discrete_timesteps(k_t, shape[0]))
    noise = np.asarray(jax.random.normal(k_n, shape, jnp.float32))
    return torch.from_numpy(t), torch.from_numpy(noise)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_port(tree):
    return weights.from_jax_numpy(_np_tree(tree))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def _tree_rel(port_tree, jax_tree) -> float:
    """Max over leaves of the per-leaf relative error (names as save_params)."""
    pf = weights.flatten(port_tree)
    jf = weights.flatten(_np_tree(jax_tree))
    names = [n for n, v in pf.items() if v is not None]
    assert names and sorted(names) == sorted(n for n, v in jf.items() if v is not None)
    return max(_rel(pf[n].detach().float().numpy(), jf[n]) for n in names)


def _update_rel(port_tree, jax_tree, jax_tree0) -> float:
    """Max over leaves of |port update - JAX update| / |JAX update| (norms),
    each update taken from ``jax_tree0``; a leaf that JAX leaves as it was
    must stay exactly."""
    pf, jf = weights.flatten(port_tree), weights.flatten(_np_tree(jax_tree))
    f0 = weights.flatten(_np_tree(jax_tree0))
    worst = 0.0
    for n, p0 in f0.items():
        p0 = np.asarray(p0, np.float32)
        ref = np.asarray(jf[n], np.float32) - p0
        err = float(np.linalg.norm(pf[n].detach().float().numpy() - p0 - ref))
        worst = max(worst, err / float(np.linalg.norm(ref)) if err else 0.0)
    return worst


@pytest.fixture(scope="module")
def params():
    return jdit.init_params(jax.random.key(0), TINY, dtype=jnp.float32)


def test_discrete_timesteps_from_schedule():
    g = torch.Generator().manual_seed(0)
    t = tfm.sample_discrete_timesteps(g, 64)
    valid = torch.tensor(SHIFT_TIMESTEPS[3.0], dtype=torch.float32)
    assert t.dtype == torch.float32 and t.shape == (64,)
    assert all(bool((valid == v).any()) for v in t)
    assert len(set(t.tolist())) > 3


def test_loss_and_grads_match_jax(params):
    key = jax.random.key(7)
    jb = _jb(_batch())

    def f(p):
        return jfm.flow_matching_loss(p, TINY, jb, key)

    l_jax, g_jax = jax.jit(jax.value_and_grad(f))(params)
    tp = _to_port(params)
    live = [x.detach().requires_grad_() for x in weights.tree_leaves(tp)]
    t, noise = _draws(key)
    loss = tfm.flow_matching_loss(weights.tree_unflatten(tp, live), TTINY, _tb(_batch()), t, noise)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
    assert abs(float(loss) - float(l_jax)) <= 1e-5 * abs(float(l_jax))
    assert _tree_rel(weights.tree_unflatten(tp, grads), g_jax) <= 1.5 * GRAD_SPREAD


def test_masked_loss_reads_only_the_mask(params):
    """Frames outside the loss mask change the loss only through the DiT's
    attention, and a mask of zeros gives 0 (the clamp keeps it finite)."""
    tp = _to_port(params)
    b = _tb(_batch())
    t, noise = _draws(jax.random.key(3))
    b["loss_mask"] = torch.zeros_like(b["loss_mask"])
    assert float(tfm.flow_matching_loss(tp, TTINY, b, t, noise)) == 0.0


@pytest.mark.parametrize("scale", [0.01, 30.0], ids=["clip_idle", "clip_active"])
def test_optimizer_matches_optax(scale):
    rng = np.random.default_rng(1)
    shapes = {"w": (5, 7), "b": (7,), "deep": [{"k": (3, 4)}, {"k": (4, 2)}]}
    jp = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32),
                                shapes, is_leaf=lambda x: isinstance(x, tuple))
    opt = jfm.make_optimizer(lr=3e-2, weight_decay=0.05, warmup_steps=2, total_steps=8,
                             clip_norm=1.0)
    topt = tfm.make_optimizer(lr=3e-2, weight_decay=0.05, warmup_steps=2, total_steps=8,
                              clip_norm=1.0)
    js = opt.init(jp)
    tp = _to_port(jp)
    ts = topt.init(tp)
    for step in range(6):
        jg = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * scale, jnp.float32), jp)
        norm = float(optax.global_norm(jg))
        assert (norm >= 1.0) == (scale > 1), norm
        upd, js = opt.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = weights.tree_leaves(_to_port(jg))
        new, ts = topt.apply(weights.tree_leaves(tp), tg, ts,
                             float(topt.global_norm(tg)))
        tp = weights.tree_unflatten(tp, new)
        assert topt.schedule(step) == pytest.approx(
            float(optax.warmup_cosine_decay_schedule(0.0, 3e-2, 2, 8)(step)), rel=1e-6)
        for got, ref in zip(weights.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert _rel(got.numpy(), ref) <= OPT_RTOL
    adam = js[1][0]
    assert ts.count == int(adam.count) == int(js[1][2].count) == 6
    for got, ref in zip(weights.tree_leaves(ts.mu) + weights.tree_leaves(ts.nu),
                        jax.tree_util.tree_leaves(adam.mu) + jax.tree_util.tree_leaves(adam.nu)):
        assert _rel(got.numpy(), ref) <= OPT_RTOL


def test_first_step_learning_rate_is_zero():
    topt = tfm.make_optimizer(lr=1e-3, warmup_steps=10, total_steps=100)
    assert topt.schedule(0) == 0.0 and topt.schedule(10) == pytest.approx(1e-3)
    assert topt.schedule(100) == 0.0
    with pytest.raises(ValueError, match="total_steps"):
        tfm.make_optimizer(warmup_steps=10, total_steps=10)


def test_moments_take_the_params_dtype():
    """optax's moments are zeros_like(params): a bf16 full fine-tune keeps bf16
    moments, and the update keeps each leaf's dtype."""
    topt = tfm.make_optimizer(lr=0.1, warmup_steps=0, total_steps=10)
    params = [torch.ones(4, 3, dtype=torch.bfloat16), torch.ones(5)]
    state = topt.init(params)
    grads = [torch.full((4, 3), 0.5, dtype=torch.bfloat16), torch.full((5,), 0.5)]
    new, state = topt.apply(params, grads, state, float(topt.global_norm(grads)))
    assert [x.dtype for x in new] == [torch.bfloat16, torch.float32]
    assert [x.dtype for x in weights.tree_leaves(state.mu) + weights.tree_leaves(state.nu)] == \
        [torch.bfloat16, torch.float32] * 2
    assert all(bool((x < 1).all()) for x in new) and state.count == 1


def _steps(mode, params):
    """(JAX eager step, port step, JAX init tree) of ``mode``."""
    opt = jfm.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    topt = tfm.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    if mode == "full":
        return (jfm.make_train_step(TINY, opt, jit=True), tfm.make_train_step(TTINY, topt),
                params, opt, topt)
    base = _to_port(params)
    if mode == "lora":
        return (jlora.make_lora_train_step(params, TINY, opt, alpha=8.0, jit=False),
                tlora.make_lora_train_step(base, TTINY, topt, alpha=8.0),
                jlora.init_lora(jax.random.key(1), params, rank=4), opt, topt)
    return (jlokr.make_lokr_train_step(params, TINY, opt, alpha=1.0, jit=False),
            tlokr.make_lokr_train_step(base, TTINY, topt, alpha=1.0),
            jlokr.init_lokr(jax.random.key(1), params, factor=4), opt, topt)


@pytest.mark.parametrize("mode", ["full", "lora", "lokr"])
def test_three_steps_match_jax(mode, params):
    jstep, tstep, tree0, opt, topt = _steps(mode, params)
    jt, js = tree0, opt.init(tree0)
    tt = _to_port(tree0)
    ts = topt.init(tt)
    for i in range(3):
        key = jax.random.key(100 + i)
        jt, js, jl = jstep(jt, js, _jb(_batch(i)), key)
        t, noise = _draws(key)
        tt, ts, tl = tstep(tt, ts, _tb(_batch(i)), t, noise)
        assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl)), (i, float(tl), float(jl))
    assert ts.count == 3
    err = _tree_rel(tt, jt)
    assert err <= (FULL_TOL if mode == "full" else ADAPTER_TOL), err
    if mode == "full":
        upd = _update_rel(tt, jt, tree0)
        assert upd <= UPDATE_TOL, upd
    if mode != "full":
        # the base is frozen: the merge covers what the loss reads
        merged = (tlora.apply_lora if mode == "lora" else tlokr.apply_lokr)(
            _to_port(params), tt, 8.0 if mode == "lora" else 1.0)
        assert not torch.equal(merged["layers"][0]["mlp"]["up_proj"]["kernel"],
                               _to_port(params)["layers"][0]["mlp"]["up_proj"]["kernel"])


def _nan_batch():
    b = _batch()
    b["latents"][0, 0, 0] = np.nan
    return b


def test_full_guard_keeps_params_and_state(params):
    """On a non-finite gradient the full step keeps the params and the whole
    optimizer state, count included (flow_matching.py:103-121)."""
    topt = tfm.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=10)
    tstep = tfm.make_train_step(TTINY, topt)
    tp = _to_port(params)
    ts = topt.init(tp)
    t, noise = _draws(jax.random.key(0))
    new, state, loss = tstep(tp, ts, _tb(_nan_batch()), t, noise)
    assert not np.isfinite(float(loss))
    assert new is tp and state is ts and state.count == 0


@pytest.mark.parametrize("mode", ["lora", "lokr"])
def test_adapter_guard_keeps_adapter_and_advances_state(mode, params):
    """The adapter steps zero the bad gradients and keep the adapter, but the
    optimizer state advances (lora.py:157-169): the count and the decayed
    moments equal the JAX step's."""
    jstep, tstep, tree0, opt, topt = _steps(mode, params)
    jt, js = tree0, opt.init(tree0)
    tt = _to_port(tree0)
    ts = topt.init(tt)
    key = jax.random.key(5)
    jt, js, _ = jstep(jt, js, _jb(_batch()), key)
    tt, ts, _ = tstep(tt, ts, _tb(_batch()), *_draws(key))
    before = [x.clone() for x in weights.tree_leaves(tt)]
    jt2, js2, jl = jstep(jt, js, _jb(_nan_batch()), key)
    tt2, ts2, tl = tstep(tt, ts, _tb(_nan_batch()), *_draws(key))
    assert not np.isfinite(float(tl)) and not np.isfinite(float(jl))
    assert all(torch.equal(a, b) for a, b in zip(before, weights.tree_leaves(tt2)))
    assert ts2.count == 2 == int(js2[1][0].count)
    for got, ref in zip(weights.tree_leaves(ts2.mu), jax.tree_util.tree_leaves(js2[1][0].mu)):
        assert _rel(got.numpy(), ref) <= ADAPTER_TOL
    assert any(float(m.abs().max()) > 0 for m in weights.tree_leaves(ts2.mu))


def test_lora_init_shapes_and_targets(params):
    tp = _to_port(params)
    g = torch.Generator().manual_seed(0)
    lora = tlora.init_lora(g, tp, rank=4)
    jl = jlora.init_lora(jax.random.key(0), params, rank=4)
    pf, jf = weights.flatten(lora), weights.flatten(_np_tree(jl))
    assert {n for n, v in pf.items() if v is not None} == {n for n, v in jf.items()
                                                           if v is not None}
    for n, v in pf.items():
        if v is not None:
            assert tuple(v.shape) == jf[n].shape and v.dtype == torch.float32
            if n.endswith("/b"):
                assert not v.any()
    lk = tlokr.init_lokr(g, tp, factor=4)
    jk = jlokr.init_lokr(jax.random.key(0), params, factor=4)
    kf, jkf = weights.flatten(lk), weights.flatten(_np_tree(jk))
    assert all(tuple(kf[n].shape) == jkf[n].shape for n, v in kf.items() if v is not None)
    for n in (1, 12, 36, 97, 2048, 6144):
        for target in (1, 4, 8):
            assert tlokr._factor_dim(n, target) == jlokr._factor_dim(n, target)


def test_lora_on_a_quantized_base_matches_jax(params):
    """A q8_0 base: both packages requantize the merged kernel, so the adapter's
    gradient passes only through each block's scale (its absolute maximum).
    The port's merged loss and its grads equal the JAX package's."""
    q_params = jax.tree_util.tree_map(lambda x: x, params)
    layer = dict(q_params["layers"][0])
    mlp = dict(layer["mlp"])
    mlp["up_proj"] = {"kernel": quantize_jax(mlp["up_proj"]["kernel"] * 4.0, "q8_0")}
    layer["mlp"] = mlp
    q_params["layers"] = [layer]
    lora = jlora.init_lora(jax.random.key(2), q_params, rank=4)
    lora = jax.tree_util.tree_map(lambda x: x, lora)
    lora["layers"][0]["mlp"]["up_proj"]["kernel"]["b"] = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 64)) * 0.05, jnp.float32)
    key = jax.random.key(9)
    jb = _jb(_batch())

    def f(lr):
        return jfm.flow_matching_loss(jlora.apply_lora(q_params, lr, 8.0), TINY, jb, key)

    jl, jg = jax.value_and_grad(f)(lora)
    base = _to_port(q_params)
    tl = _to_port(lora)
    live = [x.detach().requires_grad_() for x in weights.tree_leaves(tl)]
    t, noise = _draws(key)
    merged = tlora.merge_tree(tfm.loss_params(base), weights.tree_unflatten(tl, live),
                              lambda w, ll: tlora.train_delta(ll, 8.0))
    loss = tfm.flow_matching_loss(merged, TTINY, _tb(_batch()), t, noise)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)]
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    gq = weights.flatten(weights.tree_unflatten(tl, grads))
    jq = weights.flatten(_np_tree(jg))
    name = "layers/0/mlp/up_proj/kernel/b"
    np.testing.assert_allclose(gq[name].numpy(), jq[name], rtol=2e-2,
                               atol=2e-2 * np.abs(jq[name]).max())
    assert np.abs(jq[name]).max() > 0


# ---------------------------------------------------------------------------
# the VAE's gradient
# ---------------------------------------------------------------------------

GRAD_VAE = VAEConfig(audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
                     decoder_input_channels=8, downsampling_ratios=(2, 4, 4),
                     channel_multiples=(1, 2, 4))
VAE_GRAD_RTOL = 1e-4      # f32 convs in both packages


def test_vae_decode_grads_match_jax():
    """jax.grad of the JAX vae.decode against the port's autograd, w.r.t. the
    latents and every parameter (small widths: the convs' plain path)."""
    rng = np.random.default_rng(0)
    jparams = _vae_params(jax.random.key(0), GRAD_VAE, rng, affine_scale=0.1)
    lat = rng.standard_normal((1, 6, 8)).astype(np.float32)
    out_shape = jax.eval_shape(lambda p, x: jvae.decode(p, GRAD_VAE, x), jparams,
                               jnp.asarray(lat)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)

    def f(p, x):
        return jnp.sum(jvae.decode(p, GRAD_VAE, x) * w)

    jg_p, jg_x = jax.jit(jax.grad(f, argnums=(0, 1)))(jparams, jnp.asarray(lat))
    tp = _to_port(jparams)
    live = [x.detach().requires_grad_() for x in weights.tree_leaves(tp)]
    x = torch.from_numpy(lat).requires_grad_()
    out = tvae.decode(weights.tree_unflatten(tp, live), TVAEConfig(**dataclasses.asdict(GRAD_VAE)),
                      x)
    gs = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), [x] + live,
                             allow_unused=True)
    assert _rel(gs[0].numpy(), jg_x) <= VAE_GRAD_RTOL
    gp = [torch.zeros_like(v) if g is None else g for v, g in zip(live, gs[1:])]
    assert _tree_rel(weights.tree_unflatten(tp, gp), jg_p) <= VAE_GRAD_RTOL
    with torch.no_grad():
        assert not tvae.decode(tp, TVAEConfig(**dataclasses.asdict(GRAD_VAE)),
                               torch.from_numpy(lat)).requires_grad


def _unit(c, seed, scale=0.2):
    rng = np.random.default_rng(seed)

    def t(*s, k=scale):
        return torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32))

    return {"snake1": {"alpha": t(c), "beta": t(c)}, "conv1": {"w": t(7, c, c, k=0.05),
                                                               "b": t(c)},
            "snake2": {"alpha": t(c), "beta": t(c)}, "conv2": {"w": t(1, c, c, k=0.05),
                                                               "b": t(c)}}


def _grads(fn, x, units):
    leaves = [v for u in units for part in u.values() for v in part.values()]
    for v in [x] + leaves:
        v.requires_grad_()
    out = fn(x, units)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape).astype(np.float32))
    gs = torch.autograd.grad((out * w).sum(), [x] + leaves)
    for v in [x] + leaves:
        v.requires_grad_(False)
    return out.detach(), gs


@pytest.mark.parametrize("kind", ["unit", "trio"])
def test_res_kernel_gradient_function(kind):
    """KernelGrad (the card's path) with its launch stood in by the plain
    forward: its gradients w.r.t. x and every parameter equal autograd through
    the plain version (the CPU path), and match jax.grad of the JAX kernel
    (Pallas interpret mode, whose backward is its XLA copy) within 1e-4."""
    c, d = (256, 3) if kind == "unit" else (128, None)
    units = (_unit(c, 0),) if kind == "unit" else tuple(_unit(c, s) for s in range(3))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 24, c)).astype(np.float32))

    def cpu_path(xx, us):
        return tvru.fused_res_unit(us[0], xx, d) if kind == "unit" else tvru.fused_res_trio(us, xx)

    def card_path(xx, us):     # the CUDA branch, its kernel replaced by the plain forward
        if kind == "unit":
            tens = tvru.unit_tensors(us[0])

            def plain(a, *tt):
                return tvru.res_unit_plain(a, *tt, d)
        else:
            per = [tvru.unit_tensors(u) for u in us]
            tens = tuple(torch.stack([p[i] for p in per]) for i in range(8))
            plain = tvru.res_trio_plain
        ops = [t.detach() for t in tens]

        def launch(a):
            return plain(a, *ops)

        return tvru.KernelGrad.apply(launch, plain, xx, *tens)

    ref_out, ref = _grads(cpu_path, x, units)
    out, got = _grads(card_path, x, units)
    assert torch.equal(out, ref_out)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max()) + 1e-12

    jx = jnp.asarray(x.numpy())
    jus = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), units)
    w = np.random.default_rng(3).standard_normal(ref_out.shape).astype(np.float32)

    def jf(xx, us):
        out = (jvru.fused_res_unit(us[0], xx, d, interpret=True) if kind == "unit"
               else jvru.fused_res_trio(us, xx, interpret=True))
        return jnp.sum(out * w)

    jgx, jgu = jax.grad(jf, argnums=(0, 1))(jx, jus)
    assert _rel(got[0].numpy(), jgx) <= 1e-4
    jleaves = [jgu[i][part][k] for i, u in enumerate(units) for part in u for k in u[part]]
    for g, r in zip(got[1:], jleaves):
        assert _rel(g.numpy(), r) <= 1e-4
