"""The port's quant evals against the JAX package on the CPU, at small
configs: train_quality_eval's phase eval against the JAX tool's own
``phase_eval`` (tools/train_quality_eval.py, its ``_configs`` monkeypatched;
nothing under tools/ is edited), and eval_quant_pipeline's rows against the
JAX engine run as tools/eval_quant_pipeline.py runs it (:func:`jax_rows`: its
request, ``quantize_tree_jax`` of one bf16 tree per format, a warm-up and a
timed request per variant, ``waveform_metrics`` and the latent cosine).

Both sides start from the same weights and noise: the JAX package's trees
(numpy draws through ``init_params``' sampler, or the tool's own
``jax.random`` keys) carried across with ``weights.from_jax_numpy``, and
``sampler.make_noise`` of the request's seed.  The port quantizes with its
own quantizers, which equal the numpy ones (``quant.convert.quantize_tree``,
held bit for bit here); the JAX tools use ``quantize_tree_jax``, which moves
a rare value by one step (ROADMAP §3): the tolerances below absorb that.

Tolerances (``_check_rows``): each variant's audio against the JAX side's
WAV of the same variant at the Q8_0 gate (cosine >= 0.999, SNR >= 26 dB);
each quant row's 1 - cosine and 1 - latent cosine within half of the JAX
row's (plus 1e-6), its SNR within 2 dB: each package's rows compare its
variant with its own bf16 audio, and XLA and torch round the bf16 DiT
differently.  Measured on the CPU: the audio at cosine >= 0.99938 and SNR >=
29.05 dB (phase eval's q4_k; its other variants >= 36 dB), 1 - cosine within
15.7% and 1 - latent cosine within 8.7% of the JAX rows', SNR within 0.75
dB, the decoder-leg control's SNR within 0.75 dB.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acestep_tpu import loader as jloader
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import QwenConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.models import qwen as jqwen
from acestep_tpu.models import vae as jvae
from acestep_tpu.quant.convert import quantize_tree as np_quantize_tree
from acestep_tpu_torch import eval_quant_pipeline as teqp
from acestep_tpu_torch import train_quality_eval as ttqe
from acestep_tpu_torch.eval_metrics import cosine, snr_db
from acestep_tpu_torch.quant import FIELDS, QuantTensor
from acestep_tpu_torch.utils.audio import read_wav
from acestep_tpu_torch.weights import flatten
from tests.test_torch_models import _vae_params, port_cfg, to_np
from tests.test_torch_quality_eval import CFGS, DIT, JTQE, TEXT, VAE, _to_port
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

# eval_quant_pipeline's request draws token ids below 150000
TEXT_150K = QwenConfig(**dict(TEXT.__dict__, vocab_size=150000))
GATE_COSINE, GATE_SNR_DB = 0.999, 26.0
ROW_TOL = {"one_minus_cos": 0.5, "snr_db": 2.0}


def _frames(duration):
    return jpipeline.bucket_frames(jpipeline.frames_for_duration(duration))


def _numpy_dit(seed, dtype):
    rng = np.random.default_rng(seed)
    return jdit.init_params(jax.random.key(seed), DIT, dtype=dtype,
                            sampler=lambda s: rng.standard_normal(s).astype(np.float32))


def _check_rows(got, ref, got_dir, ref_audio):
    """The port's rows and WAVs against the JAX side's (module docstring)."""
    assert [r["variant"] for r in got] == [r["variant"] for r in ref]
    for r in got:
        b, sr = read_wav(os.path.join(got_dir, f"{r['variant']}.wav"))
        a = ref_audio(r["variant"])
        assert sr == VAE.sampling_rate and a.shape == b.shape == (8000, 2)
        assert cosine(a, b) >= GATE_COSINE and snr_db(a, b) >= GATE_SNR_DB, r["variant"]
    for g, r in zip(got[1:], ref[1:]):
        gm, rm = g["metrics"], r["metrics"]
        for key in ("cosine", "latent_cos"):
            assert abs(gm[key] - rm[key]) <= ROW_TOL["one_minus_cos"] * (1 - rm[key]) + 1e-6, (
                g["variant"], key, gm[key], rm[key])
        assert abs(gm["snr_db"] - rm["snr_db"]) <= ROW_TOL["snr_db"], (g["variant"], gm, rm)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """The JAX tool's phase_eval and the port's on the same files: a small
    f32 DiT saved as ``train/dit_trained`` and a VAE saved as the trained one."""
    out = str(tmp_path_factory.mktemp("eval"))
    key = jax.random.key(11)
    jloader.save_params(os.path.join(out, "vae_trained"),
                        _vae_params(key, VAE, np.random.default_rng(11)))
    os.makedirs(os.path.join(out, "train"))
    jloader.save_params(os.path.join(out, "train", "dit_trained"),
                        _numpy_dit(5, jnp.float32))
    # the random VAE and text encoder the eval draws (the tool's _init_params,
    # whose DiT phase_eval discards), from numpy: the tool's jitted
    # jax.random inits are the slowest compiles here
    assert JTQE._init_params.__code__.co_varnames[:6] == (
        "jnp", "jax", "dit_cfg", "vae_cfg", "text_cfg", "dtype")
    rng = np.random.default_rng(4)
    rand_vae = _vae_params(jax.random.key(4), VAE, rng)
    text = jqwen.init_params(jax.random.key(4), TEXT, dtype=jnp.bfloat16,
                             sampler=lambda s: rng.standard_normal(s).astype(np.float32))
    mp = pytest.MonkeyPatch()
    mp.setattr(JTQE, "_configs", lambda: CFGS)
    mp.setattr(JTQE, "_init_params", lambda *a: (None, rand_vae, text))
    # the decoder-leg control on a jitted decode (the tool's is eager: op by
    # op, slower to compile here)
    mp.setattr(jvae, "decode", jax.jit(jvae.decode, static_argnums=1))
    mp.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")
    try:
        JTQE.phase_eval(out, os.path.join(out, "report_jax"))
    finally:
        mp.undo()
    noise = jsampler.make_noise([17], (1, _frames(JTQE.SONG_S), DIT.audio_acoustic_hidden_dim))
    port = ttqe.phase_eval(out, os.path.join(out, "report_port"),
                           cfgs=tuple(port_cfg(c) for c in CFGS),
                           params=(_to_port(rand_vae), _to_port(text)),
                           noise=torch.from_numpy(np.asarray(noise)), device="cpu",
                           log=lambda m: None)
    with open(os.path.join(out, "report_jax", "summary.json")) as f:
        ref = json.load(f)
    return out, ref, port


def test_phase_eval_rows_match_jax(eval_runs):
    out, ref, got = eval_runs
    assert got["vae_trained"] and ref["vae_trained"]
    assert [r["variant"] for r in got["rows"]] == ["fp_bf16", "q8_0", "q4_0", "q4_k", "q6_k"]
    _check_rows(got["rows"], ref["rows"], os.path.join(out, "report_port"),
                lambda v: read_wav(os.path.join(out, "report_jax", f"{v}.wav"))[0])
    assert [d["decoder"] for d in got["decoder_control"]] == ["trained", "random"]
    for g, r in zip(got["decoder_control"], ref["decoder_control"]):
        assert abs(g["metrics"]["snr_db"] - r["metrics"]["snr_db"]) <= ROW_TOL["snr_db"]
    md = open(os.path.join(out, "report_port", "summary.md")).read()
    assert "| q4_k |" in md and "Decoder-leg control" in md and "clap" not in md


@pytest.fixture(scope="module")
def eq_trees():
    """A bf16 DiT and text encoder (vocab 150000: eval_quant_pipeline's
    request) and a VAE of the JAX package, numpy draws."""
    rng = np.random.default_rng(2)
    sampler = lambda s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    text = jqwen.init_params(jax.random.key(2), TEXT_150K, dtype=jnp.bfloat16, sampler=sampler)
    return (_numpy_dit(1, jnp.bfloat16), _vae_params(jax.random.key(3), VAE,
                                                     np.random.default_rng(3)), text)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0", "q4_k", "q6_k"])
def test_quantized_trees_equal_the_numpy_quantizer(eq_trees, fmt):
    """The trees each variant serves: the port's quantizers on the unstacked
    bf16 tree equal the JAX package's numpy ``quantize_tree`` leaf for leaf
    and byte for byte, each kernel at ``supported_format_for`` of its own K."""
    n_quant = 0
    for tree in (eq_trees[0], eq_trees[2]):      # the DiT; the text encoder
        ref = flatten(np_quantize_tree(to_np(tree), fmt))
        got = flatten(teqp.quantized(_to_port(tree), fmt))
        assert sorted(ref) == sorted(got)
        for name, r in ref.items():
            g = got[name]
            if hasattr(r, "fmt"):
                n_quant += 1
                assert isinstance(g, QuantTensor) and g.fmt == r.fmt, name
                for f in FIELDS:
                    if getattr(r, f, None) is not None:
                        np.testing.assert_array_equal(
                            g.fields()[f].view(torch.int16).numpy().view(np.uint16)
                            if g.fields()[f].dtype == torch.bfloat16
                            else g.fields()[f].numpy(), np.asarray(getattr(r, f)), name)
            else:
                assert not isinstance(g, QuantTensor), name
    assert n_quant > 0


def test_quantized_refuses_a_stacked_tree(eq_trees):
    from acestep_tpu_torch.models.stacking import stack_layer_params

    tree = _to_port(eq_trees[0])
    with pytest.raises(ValueError, match="unstacked"):
        teqp.quantized(dict(tree, layers=stack_layer_params(tree["layers"])), "q8_0")
