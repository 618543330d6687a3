"""The port's eval_quant_pipeline and ablate_quant_noise against the JAX
package on the CPU, at small configs, and the port's config constants.

eval_quant_pipeline's rows are held to the JAX engine run as
tools/eval_quant_pipeline.py runs it (:func:`jax_rows`: its request,
``quantize_tree_jax`` of one bf16 DiT and text-encoder tree per format, a
warm-up and a timed request per variant, ``waveform_metrics`` and the latent
cosine), on the same trees and noise; the tolerances are
test_torch_quant_eval.py's (``_check_rows``).

The ablation's parts A and B (at 2 layers) are held to the JAX tool's own
``part_a_format_level`` and ``_forward_cos`` (tools/ablate_quant_noise.py),
the port given the tool's ``init_params(key(1))`` draw:
  * A: the q8_0 reconstruction cosine and RMSE exactly (the quantizers are
    bit-equal and both dequantize in f32); the matmul-output cosine's
    1 - cosine within 40% of the JAX value's: the port's q8_0 dequant-matmul
    rounds x and the dequantized weight to bf16, as the kernel does, where
    the JAX tool multiplies in f32 (measured 19.8% and 19.3%: 1 - cosine
    1.73e-5 against 1.44e-5);
  * B: the forward's 1 - cosine within 25% of the JAX value's (measured
    0.05%; both quantized forwards take bf16 products).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acestep_tpu.config as jcfg
import acestep_tpu_torch.config as tcfg
from acestep_tpu import eval_metrics as jmetrics
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig as JDiTConfig
from acestep_tpu.models import dit as jdit
from acestep_tpu.quant import quantize_tree_jax
from acestep_tpu.utils.audio import write_wav as jwrite_wav
from acestep_tpu_torch import ablate_quant_noise as taqn
from acestep_tpu_torch import eval_quant_pipeline as teqp
from acestep_tpu_torch.utils.audio import read_wav
from tests.test_torch_models import port_cfg
from tests.test_torch_quality_eval import DIT, REPO, VAE, _to_port
from tests.test_torch_quant_eval import (  # noqa: F401  (eq_trees: a fixture)
    TEXT_150K, _check_rows, _frames, eq_trees)
from tests.torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

EQ_FORMATS = ("q4_k",)
ABL_A_RTOL = 0.4
ABL_RTOL = 0.25


def _jax_ablation():
    spec = importlib.util.spec_from_file_location("jax_ablate_quant_noise",
                                                  REPO / "tools" / "ablate_quant_noise.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_rows(fp_dit, vae_p, fp_text, duration, seed, formats, out):
    """tools/eval_quant_pipeline.py:66-119 on given trees and configs: the
    rows, each variant's WAV written under ``out``."""
    rng = np.random.default_rng(0)
    req = jpipeline.GenerationRequest(duration_s=duration,
                                      style_token_ids=rng.integers(0, 150000, (1, 64)),
                                      lyric_token_ids=rng.integers(0, 150000, (1, 256)),
                                      seeds=[seed])

    def run(name, dit_p, text_p):
        engine = jpipeline.AceStepEngine(dit_p, DIT, vae_p, VAE, text_p, TEXT_150K)
        engine.generate(req)
        res = engine.generate(req)
        jwrite_wav(os.path.join(out, f"{name}.wav"), res.audio[0], res.sample_rate)
        return res.audio[0], res.latents[0]

    fp_wav, fp_lat = run("fp_bf16", fp_dit, fp_text)
    rows = [{"variant": "fp_bf16", "metrics": None}]
    for fmt in formats:
        wav, lat = run(fmt, quantize_tree_jax(fp_dit, fmt), quantize_tree_jax(fp_text, fmt))
        m = jmetrics.waveform_metrics(fp_wav, wav)
        m["latent_cos"] = teqp.latent_cosine(fp_lat, lat)
        rows.append({"variant": fmt, "metrics": m})
    return rows


def test_eval_quant_pipeline_rows_match_jax(eq_trees, tmp_path, monkeypatch):
    monkeypatch.setenv("ACESTEP_TPU_QMM_BACKEND", "xla")
    os.makedirs(tmp_path / "jax")
    ref = jax_rows(*eq_trees, 10.0, 1, EQ_FORMATS, str(tmp_path / "jax"))
    req = teqp.request(10.0, 1)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(req.style_token_ids, rng.integers(0, 150000, (1, 64)))
    np.testing.assert_array_equal(req.lyric_token_ids, rng.integers(0, 150000, (1, 256)))
    noise = jsampler.make_noise([1], (1, _frames(10.0), DIT.audio_acoustic_hidden_dim))
    got = teqp.evaluate(str(tmp_path / "port"), formats=EQ_FORMATS, seed=1, device="cpu",
                        cfgs=(port_cfg(DIT), port_cfg(VAE), port_cfg(TEXT_150K)),
                        trees=tuple(_to_port(t) for t in eq_trees),
                        noise=torch.from_numpy(np.asarray(noise)), log=lambda m: None)
    _check_rows(got, ref, str(tmp_path / "port"),
                lambda v: read_wav(str(tmp_path / "jax" / f"{v}.wav"))[0])
    with open(tmp_path / "port" / "summary.json") as f:
        assert [r["variant"] for r in json.load(f)] == ["fp_bf16", *EQ_FORMATS]


def test_eval_quant_main_runs_on_the_cpu(tmp_path, monkeypatch):
    """``python -m acestep_tpu_torch.eval_quant_pipeline --device cpu`` at the
    small configs: its own draws, the flags, the report files."""
    monkeypatch.setattr(teqp, "full_width",
                        lambda: (port_cfg(DIT), port_cfg(VAE), port_cfg(TEXT_150K)))
    assert teqp.main(["--out", str(tmp_path), "--device", "cpu", "--formats", "q6_k",
                      "--duration", "10", "--seed", "3"]) == 0
    with open(tmp_path / "summary.json") as f:
        rows = json.load(f)
    assert [r["variant"] for r in rows] == ["fp_bf16", "q6_k"]
    assert all(np.isfinite(v) for r in rows[1:] for v in r["metrics"].values())
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == sorted(
        f"{r['variant']}.wav" for r in rows)
    assert "| q6_k |" in (tmp_path / "summary.md").read_text()


def test_ablation_parts_a_and_b_match_jax(monkeypatch):
    jtool = _jax_ablation()
    # part B's init and forwards jitted (the tool runs them eagerly: op by op,
    # slower to compile here); the port takes the same init
    monkeypatch.setattr(jdit, "init_params", jax.jit(jdit.init_params, static_argnums=(1, 2)))
    monkeypatch.setattr(jdit, "forward", jax.jit(jdit.forward, static_argnums=1))
    ref_a = jtool.part_a_format_level(np.random.default_rng(0))
    got_a = taqn.part_a(np.random.default_rng(0), torch.device("cpu"))
    assert [r[0] for r in got_a] == [r[0] for r in ref_a] == ["2048x2048", "2048x6144"]
    for (_, rc, rr, mc), (_, jrc, jrr, jmc) in zip(got_a, ref_a):
        assert rc == pytest.approx(jrc, abs=1e-12) and rr == pytest.approx(jrr, rel=1e-9)
        assert abs((1 - mc) - (1 - jmc)) <= ABL_A_RTOL * (1 - jmc), (mc, jmc)
    cfg = JDiTConfig(num_hidden_layers=2, **taqn.BASE)
    ref_b = jtool._forward_cos(cfg, 1.0, jax.random.key(1))
    params = _to_port(jdit.init_params(jax.random.key(1), cfg, dtype=jnp.float32))
    got_b = taqn.forward_cos(port_cfg(cfg), 1.0, params, torch.device("cpu"))
    assert 0.99 < ref_b < 1.0
    assert abs((1 - got_b) - (1 - ref_b)) <= ABL_RTOL * (1 - ref_b), (got_b, ref_b)


def test_ablation_main_runs_on_the_cpu(tmp_path, monkeypatch):
    """``python -m acestep_tpu_torch.ablate_quant_noise --device cpu`` with
    its shapes and depths cut down: every part, the summary, exit code 0."""
    monkeypatch.setattr(taqn, "SHAPES", ((256, 256), (256, 512)))
    monkeypatch.setattr(taqn, "DEPTHS", (1, 2))
    monkeypatch.setattr(taqn, "DEEP", 2)
    assert taqn.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    text = (tmp_path / "summary.md").read_text()
    for part in ("## A.", "## B.", "## B2.", "## C.", "depth-monotonic decay: **True**"):
        assert part in text


def test_config_constants_match_jax():
    """Every config constant of the JAX package (the default DiT, text
    encoder and VAE, and the planner sizes QWEN3_0_6B / 1_7B / 4B) equals the
    port's field by field."""
    names = [n for n in dir(jcfg) if dataclasses.is_dataclass(getattr(jcfg, n))]
    assert {"QWEN3_0_6B", "QWEN3_1_7B", "QWEN3_4B", "DiTConfig", "QwenConfig",
            "VAEConfig"} <= set(names)
    for name in names:
        ref, got = getattr(jcfg, name), getattr(tcfg, name)
        if isinstance(ref, type):
            ref, got = ref(), got()
        assert type(got).__name__ == type(ref).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), name
    assert tcfg.QWEN3_4B.hidden_size == 2560 and tcfg.QWEN3_4B.num_hidden_layers == 36
