"""Where q8_0's error on random weights comes from: a four-part ablation.
Port of the JAX package's tools/ablate_quant_noise.py.

    python -m acestep_tpu_torch.ablate_quant_noise [--out build/quant_ablation] [--device cpu]

  A   format level: q8_0 reconstruction of random 0.02-scale matrices
      (2048 x 2048, 2048 x 6144) and the cosine of a 64-row matmul's output
      (the q8_0 dequant-matmul against ``torch.matmul`` on the f32 weight);
  B   depth: one DiT forward, q8_0 against f32 weights, at 2, 6, 12 and 24
      layers of a 256-wide DiT;
  B2  the sampler: the latents after 1, 4 and 8 Euler steps
      (``sampler.sample_latents``) at 24 layers;
  C   weight scale: the 24-layer forward with every 2-D weight scaled by 1.0
      and by 0.5.

A kernel is quantized where it is 2-D with K % 32 == 0, whatever its size
(the JAX tool's policy).  On the card the q8_0 linears run the q8_0
dequant-matmul kernel (ops/cuda/qmm.py) and the f32 references
``torch.matmul``, with TF32 off (models/vae.py, which the engine's modules
import, turns it off).  ``summary.md`` goes under ``--out``; the
exit code is 1 where the format-level cosine is at most 0.999 or the
forward's cosine does not fall with depth (within 1e-3).  Runs on the card
unless ``--device cpu`` is given.  Parts B-C take their initial weights as an
argument (:func:`forward_cos`, :func:`sampler_stage_cos`), so tests pass the
JAX package's.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from acestep_tpu_torch import sampler
from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.eval_quant_pipeline import device_line, unstacked
from acestep_tpu_torch.models import dit
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.ops.cuda import qmm
from acestep_tpu_torch.ops.qlinear import precast_quant_scales
from acestep_tpu_torch.pipeline import resolve_device
from acestep_tpu_torch.quant import dequantize, quantize
from acestep_tpu_torch.quant.convert import quantize_tree
from acestep_tpu_torch.weights import walk

DEFAULT_OUT = os.path.join("build", "quant_ablation")
SHAPES = ((2048, 2048), (2048, 6144))
BASE = dict(
    hidden_size=256, intermediate_size=768, num_attention_heads=8,
    num_key_value_heads=4, head_dim=32, in_channels=24,
    audio_acoustic_hidden_dim=8, patch_size=2, sliding_window=16,
    text_hidden_dim=64, num_lyric_encoder_hidden_layers=0,
    num_timbre_encoder_hidden_layers=0, timbre_hidden_dim=8,
)
DEPTHS = (2, 6, 12, 24)
DEEP = 24                     # the depth of parts B2 and C
STEPS = (1, 4, 8)
SCALES = (1.0, 0.5)
PARAMS_SEED = 1
T_LEN, LC = 128, 16


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def part_a(rng: np.random.Generator, device) -> List[tuple]:
    """(matrix, recon cosine, recon rmse, matmul-output cosine) per shape."""
    rows = []
    for k, n in SHAPES:
        w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
        wt = torch.from_numpy(w).to(device)
        qt = quantize(wt, "q8_0")
        wd = _np(dequantize(qt, torch.float32))
        x = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).to(device)
        y_ref = torch.matmul(x, wt)
        y_q = qmm.qmm(x, precast_quant_scales(qt), out_dtype=torch.float32)
        rows.append((f"{k}x{n}", cosine(w, wd), float(np.sqrt(np.mean((w - wd) ** 2))),
                     cosine(_np(y_ref), _np(y_q))))
    return rows


def dit_config(layers: int) -> DiTConfig:
    return DiTConfig(num_hidden_layers=layers, **BASE)


def init_params(cfg: DiTConfig, device) -> Dict[str, Any]:
    """The f32 DiT drawn from ``PARAMS_SEED``, per-layer lists."""
    return unstacked(RandomInit(device, PARAMS_SEED, None, dtype=torch.float32).dit(cfg))


def _policy(path: str, a) -> bool:
    return getattr(a, "ndim", 0) == 2 and path.endswith("kernel") and a.shape[0] % 32 == 0


def _q(params, fmt: str):
    return precast_quant_scales(quantize_tree(params, fmt, policy=_policy))


def _inputs(cfg: DiTConfig, device):
    """(hs or noise, context, condition) [1, T_LEN / LC, .] f32 from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    shapes = ((1, T_LEN, cfg.audio_acoustic_hidden_dim), (1, T_LEN, cfg.context_dim),
              (1, LC, cfg.hidden_size))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
            for s in shapes]


@torch.no_grad()
def _forward(params, cfg: DiTConfig, hs, t, enc, ctx) -> torch.Tensor:
    kv = dit.compute_all_cross_kv(params, cfg, dit.compute_condition(params, cfg, enc))
    return dit.forward(params, cfg, hs, t, t, ctx, kv)


def forward_cos(cfg: DiTConfig, scale: float, params, device, fmt: str = "q8_0") -> float:
    """The cosine of one DiT forward on ``fmt`` weights against the f32
    weights, every 2-D leaf scaled by ``scale`` first."""
    if scale != 1.0:
        params = walk(params, lambda _, a: a * scale if getattr(a, "ndim", 0) == 2 else a)
    hs, ctx, enc = _inputs(cfg, device)
    t = torch.full((1,), 0.5, device=device)
    return cosine(_np(_forward(params, cfg, hs, t, enc, ctx)),
                  _np(_forward(_q(params, fmt), cfg, hs, t, enc, ctx)))


def sampler_stage_cos(cfg: DiTConfig, params, device, fmt: str = "q8_0") -> List[tuple]:
    """(steps, latent cosine, mean |x0|, mean error) after 1, 4 and 8 Euler
    steps, ``fmt`` against f32."""
    qparams = _q(params, fmt)
    noise, ctx, enc = _inputs(cfg, device)
    full = sampler.get_timestep_schedule(3.0)
    rows = []
    for n_steps in STEPS:
        ref = sampler.sample_latents(params, cfg, noise, ctx, enc, None, full[:n_steps])
        q = sampler.sample_latents(qparams, cfg, noise, ctx, enc, None, full[:n_steps])
        rows.append((n_steps, cosine(_np(ref), _np(q)), float(ref.abs().mean()),
                     float((ref - q).abs().mean())))
    return rows


def run(out: Optional[str] = DEFAULT_OUT, device=None) -> Dict[str, Any]:
    """Every part on weights from :func:`init_params`; returns their rows and
    the verdict, writes ``<out>/summary.md`` where ``out`` is given."""
    dev = resolve_device(device)
    a_rows = part_a(np.random.default_rng(0), dev)
    b_rows = [(layers, forward_cos(dit_config(layers), 1.0,
                                   init_params(dit_config(layers), dev), dev))
              for layers in DEPTHS]
    deep = dit_config(DEEP)
    b2_rows = sampler_stage_cos(deep, init_params(deep, dev), dev)
    c_rows = [(s, forward_cos(deep, s, init_params(deep, dev), dev)) for s in SCALES]
    ok_a = all(mc > 0.999 for *_, mc in a_rows)
    decays = all(b_rows[i][1] >= b_rows[i + 1][1] - 1e-3 for i in range(len(b_rows) - 1))
    lines = ["# Quant-noise ablation", "",
             device_line(dev), "",
             "## A. Format level (q8_0 on random 0.02-scale matrices)", "",
             "| matrix | recon cosine | recon rmse | matmul-output cosine |",
             "|---|---:|---:|---:|"]
    lines += [f"| {name} | {rc:.6f} | {rr:.2e} | {mc:.6f} |" for name, rc, rr, mc in a_rows]
    lines += ["", "## B. Depth compounding (one DiT forward, q8_0 vs f32)", "",
              "| layers | output cosine |", "|---:|---:|"]
    lines += [f"| {layers} | {c:.5f} |" for layers, c in b_rows]
    lines += ["", f"## B2. Sampler amplification ({DEEP} layers; q8 vs f32 after N Euler "
              "steps)", "", "| steps | latent cosine | mean |x0| | mean err |",
              "|---:|---:|---:|---:|"]
    lines += [f"| {n} | {c:.5f} | {mag:.4f} | {err:.5f} |" for n, c, mag, err in b2_rows]
    lines += ["", f"## C. Weight-statistics sensitivity ({DEEP} layers)", "",
              "| kernel scale | output cosine |", "|---:|---:|"]
    lines += [f"| {s} | {c:.5f} |" for s, c in c_rows]
    lines += ["", "## Verdict", "",
              f"* format-level matmul cosine > 0.999: **{ok_a}**",
              f"* depth-monotonic decay: **{decays}**"]
    summary = "\n".join(lines) + "\n"
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "summary.md"), "w") as f:
            f.write(summary)
    print(summary)
    return {"a": a_rows, "b": b_rows, "b2": b2_rows, "c": c_rows, "ok_a": ok_a,
            "decays": decays}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.out, args.device)
    return 0 if res["ok_a"] and res["decays"] else 1


if __name__ == "__main__":
    sys.exit(main())
