"""Quantization quality against bf16: one request through a bf16 engine and
through one engine per quant format, every engine built from the same bf16
weights.  Port of the JAX package's tools/eval_quant_pipeline.py, without
its CLAP columns (no CLAP checkpoint is in the repository).

    python -m acestep_tpu_torch.eval_quant_pipeline [--formats q8_0,q4_0,q4_k,q6_k]
        [--duration 10] [--seed 1] [--out build/quant_eval] [--device cpu]

The weights are random and full width (DiTConfig(), QwenConfig(), VAEConfig()).
The DiT and the text encoder are drawn once, in bf16, with seeded
``torch.Generator``s on the device; each format quantizes that same tree
(``quant.convert.quantize_tree``), so only the quantization differs between
variants.  The trees are kept unstacked (per-layer lists of 2-D kernels) so
that the quantizer reads each kernel's own K; the engine stacks them.

The request is bench.py's: 64 style and 256 lyric tokens from
``default_rng(0).integers(0, 150000)`` and ``seeds=[--seed]``.  Each variant
serves it twice (a warm-up, then the timed run), writes ``<variant>.wav`` and
is freed before the next.  Every quant row holds ``waveform_metrics`` of its
audio against the bf16 audio (mae, rmse, cosine, snr_db, lsd) and the latent
cosine, which separates the DiT's share of the error from the random VAE's
magnification of it.  ``summary.md`` and ``summary.json`` go under ``--out``.

Runs on the card unless ``--device cpu`` is given; nothing falls back to the
CPU.  Tests call :func:`evaluate` at small configs with the JAX package's
trees and noise (``cfgs``, ``trees``, ``noise``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.eval_metrics import waveform_metrics
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.models.stacking import unstack_layer_params
from acestep_tpu_torch.pipeline import AceStepEngine, GenerationRequest, resolve_device
from acestep_tpu_torch.quant import QUANT_FORMATS
from acestep_tpu_torch.quant.convert import quantize_tree
from acestep_tpu_torch.utils.audio import write_wav

FORMATS = tuple(QUANT_FORMATS)
DEFAULT_OUT = os.path.join("build", "quant_eval")
TREE_SEEDS = (0, 1, 2)          # the DiT, the VAE and the text encoder


def stderr_log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def unstacked(tree):
    """A tree whose ``layers`` are stacked, with them as a per-layer list."""
    if not isinstance(tree.get("layers"), dict):
        return tree
    return dict(tree, layers=unstack_layer_params(tree["layers"]))


def draw_trees(cfgs, device, dtype=torch.bfloat16, seeds=TREE_SEEDS):
    """(DiT, VAE, text encoder) drawn on ``device``: the DiT and the text
    encoder in ``dtype`` with per-layer lists, the VAE in f32."""
    dit_cfg, vae_cfg, text_cfg = cfgs
    dit_p = RandomInit(device, seeds[0], None, dtype=dtype).dit(dit_cfg)
    vae_p = RandomInit(device, seeds[1], None).vae(vae_cfg)
    text_p = RandomInit(device, seeds[2], None, dtype=dtype).qwen(text_cfg)
    return unstacked(dit_p), vae_p, unstacked(text_p)


def quantized(tree, fmt: str):
    """``tree`` quantized to ``fmt`` where the tensors lie.  Its layers must be
    a per-layer list: the policy takes 2-D kernels only, so a stacked [L, K, N]
    kernel would stay bf16 without a word."""
    if isinstance(tree.get("layers"), dict):
        raise ValueError("quantize a tree whose layers are a per-layer list (unstacked)")
    return quantize_tree(tree, fmt)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def latent_cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def run_variant(name: str, dit_p, vae_p, text_p, cfgs, req: GenerationRequest, device,
                out_dir: str, noise: Optional[torch.Tensor] = None,
                log: Callable[[str], None] = stderr_log):
    """One engine of ``dit_p``: a warm-up request, then the timed one; writes
    ``<out_dir>/<name>.wav`` and frees the engine.  Returns (audio [L, C] f32,
    latents [T, 64], seconds of the timed request)."""
    dit_cfg, vae_cfg, text_cfg = cfgs
    engine = AceStepEngine(dit_p, dit_cfg, vae_p, vae_cfg, text_p, text_cfg, device=device)
    engine.generate(req, noise=noise)
    t0 = time.perf_counter()
    res = engine.generate(req, noise=noise)
    infer_s = time.perf_counter() - t0
    wav, lat = res.audio[0], res.latents[0]
    write_wav(os.path.join(out_dir, f"{name}.wav"), wav, res.sample_rate)
    log(f"{name}: {infer_s:.2f}s")
    del engine, res
    free(torch.device(device))
    return wav, lat, infer_s


def quant_metrics(fp_wav, fp_lat, wav, lat) -> Dict[str, float]:
    """``waveform_metrics`` against the bf16 audio, plus ``latent_cos``."""
    m = waveform_metrics(fp_wav, wav)
    m["latent_cos"] = latent_cosine(fp_lat, lat)
    return m


def table(rows: Sequence[Dict]) -> str:
    """The JAX tools' markdown table (no CLAP columns)."""
    lines = ["| variant | infer_s | latent_cos | mae | rmse | cosine | snr_db | lsd |",
             "|---|---:|---:|---:|---:|---:|---:|---:|"]
    for r in rows:
        m = r.get("metrics")
        if m is None:
            lines.append(f"| {r['variant']} | {r['infer_s']:.3f} | — | — | — | — | — | — |")
        else:
            lines.append(
                f"| {r['variant']} | {r['infer_s']:.3f} | {m['latent_cos']:.6f} "
                f"| {m['mae']:.6f} | {m['rmse']:.6f} | {m['cosine']:.6f} "
                f"| {m['snr_db']:.2f} | {m['lsd']:.4f} |")
    return "\n".join(lines)


def device_line(device: torch.device) -> str:
    if device.type == "cuda":
        return f"device: {torch.cuda.get_device_name(device)}"
    return "device: cpu"


def request(duration: float, seed: int) -> GenerationRequest:
    rng = np.random.default_rng(0)
    return GenerationRequest(duration_s=duration,
                             style_token_ids=rng.integers(0, 150000, (1, 64)),
                             lyric_token_ids=rng.integers(0, 150000, (1, 256)),
                             seeds=[seed])


def full_width():
    """(DiTConfig(), VAEConfig(), QwenConfig()): the configs the eval runs."""
    return DiTConfig(), VAEConfig(), QwenConfig()


def evaluate(out: str = DEFAULT_OUT, *, duration: float = 10.0,
             formats: Sequence[str] = FORMATS, seed: int = 1, device=None, cfgs=None,
             trees=None, noise: Optional[torch.Tensor] = None,
             log: Callable[[str], None] = stderr_log,
             on_variant: Optional[Callable[[str], None]] = None) -> List[Dict]:
    """The eval; returns its rows (``variant``, ``infer_s``, ``metrics``:
    None for bf16).  ``cfgs``: (DiTConfig, VAEConfig, QwenConfig),
    :func:`full_width` by default; ``trees``: (DiT, VAE, text encoder) in
    bf16 / f32, drawn when None; ``noise``: the initial latents, the engine's
    seeded draw when None; ``on_variant(name)`` is called after each
    variant's two requests."""
    dev = resolve_device(device)
    cfgs = cfgs or full_width()
    fp_dit, vae_p, fp_text = trees or draw_trees(cfgs, dev)
    os.makedirs(out, exist_ok=True)
    req = request(duration, seed)

    def run(name, dit_p, text_p):
        got = run_variant(name, dit_p, vae_p, text_p, cfgs, req, dev, out, noise, log)
        if on_variant is not None:
            on_variant(name)
        return got

    fp_wav, fp_lat, fp_s = run("fp_bf16", fp_dit, fp_text)
    rows = [{"variant": "fp_bf16", "infer_s": fp_s, "metrics": None}]
    for fmt in formats:
        wav, lat, infer_s = run(fmt, quantized(fp_dit, fmt), quantized(fp_text, fmt))
        rows.append({"variant": fmt, "infer_s": infer_s,
                     "metrics": quant_metrics(fp_wav, fp_lat, wav, lat)})
    summary = table(rows)
    with open(os.path.join(out, "summary.md"), "w") as f:
        f.write(f"# Quant eval — {duration:.0f}s clip, seed {seed}\n\n"
                f"(random-weight engine; metrics vs the fp_bf16 output; "
                f"{device_line(dev)})\n\n{summary}\n")
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(rows, f, indent=2)
    print(summary)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    evaluate(args.out, duration=args.duration, formats=args.formats.split(","),
             seed=args.seed, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
