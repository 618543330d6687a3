"""Quantization quality on trained weights.  Port of the JAX package's
tools/train_quality_eval.py, without its CLAP columns.

    python -m acestep_tpu_torch.train_quality_eval [--phase vae|data|train|eval|all]
        [--out build/train_quality] [--report build/train_quality/report]
        [--vae-steps 3000] [--steps 4000] [--batch-size 8] [--songs 64] [--device cpu]

A half-scale model (HALF_DIT, HALF_VAE, HALF_TEXT: the real layout at half
depth and width; a VAE of hop 32 at 800 Hz, so 25 latent frames a second as at
full scale) is trained on synthetic songs (:func:`synth_song`), then the
quant eval runs on the trained DiT through the trained decoder:

  vae    the VAE as a deterministic autoencoder: shift-tolerant waveform MSE
         (the least over 33 shifts of the recon against the target), the
         log-magnitude STFT L1 at three sizes and a latent-scale term,
         weighted 10 / 0.5 / 0.1; AdamW (peak 2e-4, warmup a tenth, cosine to
         1e-6, clip 0.5, weight decay 1e-5) on batches of 2048-sample crops;
         the best snapshot of those read every 200 steps is kept.  On the
         card the encoder's res units run rows 7-8 forward inside
         ``vae_resunit.KernelGrad`` (blocks 0-1 the trio, block 2 the unit);
  data   the songs encoded into a training dataset (``training.data``)
         through an engine that carries the trained VAE;
  train  a full fine-tune of the DiT through ``training.trainer.Trainer``;
  eval   the trained DiT in bf16 and at q8_0, q4_0, q4_k and q6_k: one 10 s
         request each (a warm-up, then the timed run), the waveform metrics
         and the latent cosine against bf16; the decoder-leg control decodes
         the same (bf16, q8_0) latent pair through the trained and the random
         decoder.  ``summary.md`` and ``summary.json`` go under ``--report``.

Phases resume: ``vae`` is skipped where ``vae_trained.json`` exists, ``data``
where the dataset's manifest does, and ``train`` resumes from its newest
checkpoint.  Runs on the card unless ``--device cpu`` is given.

The JAX tool draws its initial weights from ``jax.random`` keys, which torch
cannot reproduce: the port draws them from seeded ``torch.Generator``s
(``VAE_SEED``, ``TRAIN_SEED`` and ``eval_quant_pipeline.TREE_SEEDS``), and
every phase takes its configs and initial weights as arguments (the eval
also its noise), so tests pass the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.eval_quant_pipeline import (
    device_line, draw_trees, quant_metrics, quantized, run_variant, stderr_log, table,
    unstacked)
from acestep_tpu_torch.eval_metrics import waveform_metrics
from acestep_tpu_torch.models import vae
from acestep_tpu_torch.models.random_init import RandomInit
from acestep_tpu_torch.pipeline import AceStepEngine, GenerationRequest, resolve_device
from acestep_tpu_torch.training.data import PreprocessedDataset, build_dataset
from acestep_tpu_torch.training.flow_matching import AdamW
from acestep_tpu_torch.training.trainer import MetricsLogger, TrainConfig, Trainer
from acestep_tpu_torch.weights import tree_leaves, tree_map, tree_unflatten

HALF_DIT = dict(
    hidden_size=512, intermediate_size=1536, num_hidden_layers=8,
    num_attention_heads=16, num_key_value_heads=8, head_dim=32,
    in_channels=192, audio_acoustic_hidden_dim=64, patch_size=2,
    sliding_window=16, text_hidden_dim=256,
    num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=64,
)
HALF_VAE = dict(
    encoder_hidden_size=128, decoder_channels=16, decoder_input_channels=64,
    downsampling_ratios=(2, 4, 4), channel_multiples=(1, 2, 4),
    sampling_rate=800,
)
HALF_TEXT = dict(
    vocab_size=512, hidden_size=256, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
    head_dim=64,
)

N_SONGS = 64
SONG_S = 10.0
SR = 800
HOP = 32
CROP = 2048                                 # 64 latent frames at hop 32
FFTS = ((256, 64), (128, 32), (64, 16))     # (n_fft, hop) of the STFT terms
SHIFT = 16                                  # the MSE's shifts: -SHIFT .. SHIFT
VAE_SEED, TRAIN_SEED = 7, 3
EVAL_FORMATS = ("q8_0", "q4_0", "q4_k", "q6_k")
DEFAULT_OUT = os.path.join("build", "train_quality")


def synth_song(rng: np.random.Generator) -> np.ndarray:
    """One synthetic stereo song [SONG_S * SR, 2] f32: four bars, each a chord
    of three band-limited harmonics under an attack-decay envelope, and a
    noise-burst percussion track on a half-second grid (the JAX tool's
    draws, in its order)."""
    n = int(SONG_S * SR)
    t = np.arange(n) / SR
    audio = np.zeros((n, 2), np.float32)
    bars = 4
    bar_n = n // bars
    for b in range(bars):
        f0 = rng.uniform(55.0, 180.0)
        ratios = rng.choice([1.0, 1.25, 1.5, 2.0], size=3, replace=False)
        seg = slice(b * bar_n, (b + 1) * bar_n)
        ts = t[seg] - t[seg.start]
        env = np.minimum(ts * 8.0, 1.0) * np.exp(-ts * rng.uniform(0.2, 1.0))
        for r in ratios:
            f = f0 * r
            if f >= SR / 2:
                continue
            ph = rng.uniform(0, 2 * np.pi)
            pan = rng.uniform(0.2, 0.8)
            wave = np.sin(2 * np.pi * f * ts + ph).astype(np.float32) * env
            audio[seg, 0] += wave * pan * 0.3
            audio[seg, 1] += wave * (1 - pan) * 0.3
    beat = int(SR * 0.5)
    for k in range(0, n - beat, beat):
        burst_n = int(SR * 0.05)
        burst = rng.standard_normal(burst_n).astype(np.float32)
        burst *= np.exp(-np.arange(burst_n) / (SR * 0.01)) * 0.2
        audio[k: k + burst_n, 0] += burst
        audio[k: k + burst_n, 1] += burst
    peak = np.abs(audio).max() + 1e-6
    return audio / max(1.0, peak / 0.95)


def configs():
    """(DiTConfig, VAEConfig, QwenConfig) at half scale."""
    return DiTConfig(**HALF_DIT), VAEConfig(**HALF_VAE), QwenConfig(**HALF_TEXT)


# ---------------------------------------------------------------------------
# phase vae
# ---------------------------------------------------------------------------

def stft_logmag(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """x [B, L, C] -> per channel the framed rfft's log-magnitude
    [B * C, frames, nfft // 2 + 1], under a symmetric Hann window
    (``jnp.hanning``, not torch's periodic default)."""
    b, l, c = x.shape
    x = x.movedim(-1, 1).reshape(b * c, l)
    n_frames = (l - nfft) // hop + 1
    idx = (hop * torch.arange(n_frames, device=x.device)[:, None]
           + torch.arange(nfft, device=x.device)[None, :])
    win = torch.hann_window(nfft, periodic=False, dtype=x.dtype, device=x.device)
    return torch.log(torch.abs(torch.fft.rfft(x[:, idx] * win, dim=-1)) + 1e-5)


def vae_loss(params, cfg: VAEConfig, audio: torch.Tensor):
    """(loss, (mse, stft L1, latent-scale term)) of the autoencoder on
    ``audio`` [B, L, 2].  The MSE is the least over shifts of -SHIFT..SHIFT
    samples: the conv chain's small group delay would otherwise make silence
    the pointwise optimum at 55-180 Hz.  The latent-scale term keeps the mean
    square latent near 1, so the encoder cannot push gain the decoder
    inverts."""
    lat = vae.encode(params, cfg, audio)
    recon = vae.decode(params, cfg, lat)[:, :audio.shape[1], :]
    n = recon.shape[1]
    tgt = audio[:, SHIFT:-SHIFT, :]
    mse = torch.stack([torch.mean(torch.square(recon[:, SHIFT + d:n - SHIFT + d, :] - tgt))
                       for d in range(-SHIFT, SHIFT + 1)]).min()
    sl = sum(torch.mean(torch.abs(stft_logmag(recon, nf, h) - stft_logmag(audio, nf, h)))
             for nf, h in FFTS)
    lat_reg = torch.square(torch.mean(torch.square(lat)) - 1.0)
    return mse * 10.0 + sl * 0.5 + lat_reg * 0.1, (mse, sl, lat_reg)


def vae_optimizer(steps: int) -> AdamW:
    """The VAE's AdamW; the conservative peak: the snake / transposed-conv
    chain diverged at 1e-3."""
    return AdamW(lr=2e-4, weight_decay=1e-5, warmup_steps=max(1, steps // 10),
                 total_steps=steps, clip_norm=0.5, end_value=1e-6)


def vae_grads(params, cfg: VAEConfig, audio: torch.Tensor):
    """(loss, (mse, sl, lat_reg), the gradient of every leaf of ``params``):
    the losses as 0-d tensors on the device, zeros for a leaf the loss does
    not reach."""
    live = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss, aux = vae_loss(tree_unflatten(params, live), cfg, audio)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return (loss.detach(), tuple(a.detach() for a in aux),
            [torch.zeros_like(x) if g is None else g for x, g in zip(live, grads)])


def vae_step(params, state, opt: AdamW, cfg: VAEConfig, audio: torch.Tensor):
    """One step: (params, state, loss, (mse, sl, lat_reg))."""
    loss, aux, grads = vae_grads(params, cfg, audio)
    new, state = opt.apply([x.detach() for x in tree_leaves(params)], grads, state,
                           float(opt.global_norm(grads)))
    return tree_unflatten(params, new), state, loss, aux


def crops(rng: np.random.Generator, songs: np.ndarray, batch: int) -> np.ndarray:
    """A batch of CROP-sample crops: song indices, then offsets."""
    si = rng.integers(0, songs.shape[0], batch)
    off = rng.integers(0, songs.shape[1] - CROP, batch)
    return np.stack([songs[s, o:o + CROP] for s, o in zip(si, off)])


def phase_vae(out: str, steps: int = 3000, batch: int = 16, *,
              vae_cfg: Optional[VAEConfig] = None, params=None, n_songs: int = N_SONGS,
              device=None, log: Callable[[str], None] = stderr_log) -> Dict[str, Any]:
    """Train the VAE; writes ``<out>/vae_trained.{safetensors,json}`` and
    ``vae_trained_meta.json`` and returns the meta (with the losses read).
    ``params``: the initial f32 tree (drawn from ``VAE_SEED`` when None)."""
    dev = resolve_device(device)
    vae_cfg = vae_cfg or configs()[1]
    params = params if params is not None else RandomInit(dev, VAE_SEED, None).vae(vae_cfg)
    rng = np.random.default_rng(42)
    songs = np.stack([synth_song(rng) for _ in range(n_songs)])        # [N, L, 2]
    opt = vae_optimizer(steps)
    state = opt.init(params)
    t0 = time.perf_counter()
    best, best_params, best_step = float("inf"), params, -1
    read = []
    for step in range(steps):
        audio = torch.from_numpy(crops(rng, songs, batch)).to(dev)
        params, state, loss, (mse, sl, lat_reg) = vae_step(params, state, opt, vae_cfg, audio)
        if step % 200 == 0 or step == steps - 1:
            l = float(loss)
            # the best snapshot, so that a late spike cannot poison the export
            if np.isfinite(l) and l < best:
                best, best_params, best_step = l, params, step
            read.append({"step": step, "loss": l, "mse": float(mse), "stft": float(sl),
                         "lat_reg": float(lat_reg)})
            log(f"[vae] step {step}: loss {l:.5f} (mse {float(mse):.6f}, stft "
                f"{float(sl):.4f}, lat_reg {float(lat_reg):.4f}) "
                f"[{time.perf_counter() - t0:.0f}s]")
    if best_step >= 0 and best < float(loss):
        log(f"[vae] restoring best snapshot from step {best_step} (loss {best:.5f} vs "
            f"final {float(loss):.5f})")
        params = best_params
    # held-out recon.  The decoder is spectrally trained and well-conditioned
    # (what the quant gate needs); it does not reconstruct the waveform's
    # phase (that needs adversarial or phase objectives), so the spectral L1
    # is the quality number and the waveform cosine is kept for transparency
    test = torch.from_numpy(synth_song(np.random.default_rng(99))[None]).to(dev)
    with torch.no_grad():
        recon = vae.decode(params, vae_cfg, vae.encode(params, vae_cfg, test))
        recon = recon[:, :test.shape[1], :]
        spec_l1 = float(torch.mean(torch.abs(stft_logmag(recon, 256, 64)
                                             - stft_logmag(test, 256, 64))))
    a, b = test.cpu().numpy().ravel().astype(np.float64), recon.cpu().numpy().ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    log(f"[vae] held-out recon: spectral log-mag L1 {spec_l1:.3f} (waveform cosine "
        f"{cos:.5f}: phase not reconstructed)")
    os.makedirs(out, exist_ok=True)
    loader.save_params(os.path.join(out, "vae_trained"), params)
    meta = {"steps": steps, "batch": batch, "songs": n_songs,
            "seconds": time.perf_counter() - t0, "best_step": best_step,
            "spectral_recon_logmag_l1": spec_l1, "recon_cosine_waveform": cos,
            "note": ("spectrally-trained decoder (multi-res STFT recon, well-conditioned); "
                     "waveform-phase recon from scratch stays at the silence floor without "
                     "adversarial/phase objectives; see summary.md's decoder-leg control")}
    with open(os.path.join(out, "vae_trained_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    log(f"[vae] saved -> {out}/vae_trained")
    return dict(meta, losses=read)


def load_trained_vae(out: str, device):
    """The trained VAE if phase vae has run, else None."""
    path = os.path.join(out, "vae_trained")
    if os.path.exists(path + ".json"):
        return loader.load_params(path, device=device)
    return None


# ---------------------------------------------------------------------------
# phases data and train
# ---------------------------------------------------------------------------

def phase_data(out: str, *, cfgs=None, params=None, n_songs: int = N_SONGS, device=None,
               log: Callable[[str], None] = stderr_log) -> str:
    """The dataset of ``n_songs`` songs (style and lyric tokens in [1, 500))
    under ``<out>/dataset``.  ``params``: (DiT, VAE, text encoder) in f32,
    drawn from ``TREE_SEEDS`` when None; the trained VAE replaces the VAE."""
    dev = resolve_device(device)
    dit_cfg, vae_cfg, text_cfg = cfgs = cfgs or configs()
    dit_p, vae_p, text_p = params or draw_trees(cfgs, dev, torch.float32)
    trained = load_trained_vae(out, dev)
    if trained is not None:
        vae_p = trained
        log("[data] encoding dataset with the TRAINED VAE")
    else:
        log("[data] WARNING: no trained VAE found: dataset latents come from a random "
            "encoder (run --phase vae first)")
    engine = AceStepEngine(dit_p, dit_cfg, vae_p, vae_cfg, text_p, text_cfg, device=dev)
    rng = np.random.default_rng(42)
    samples = [{"audio": synth_song(rng),
                "style_token_ids": rng.integers(1, 500, (1, 12)),
                "lyric_token_ids": rng.integers(1, 500, (1, 16))} for _ in range(n_songs)]
    path = build_dataset(engine, samples, os.path.join(out, "dataset"))
    log(f"[data] {n_songs} songs -> {path}")
    return path


def phase_train(out: str, total_steps: int, batch_size: int, *,
                dit_cfg: Optional[DiTConfig] = None, base=None, device=None,
                log: Callable[[str], None] = stderr_log) -> Dict[str, Any]:
    """A full fine-tune of the DiT (f32; drawn from ``TRAIN_SEED`` when
    ``base`` is None) on the dataset, resumed from its newest checkpoint;
    exports ``<out>/train/dit_trained``."""
    dev = resolve_device(device)
    dit_cfg = dit_cfg or configs()[0]
    if base is None:
        base = unstacked(RandomInit(dev, TRAIN_SEED, None, dtype=torch.float32).dit(dit_cfg))
    tc = TrainConfig(mode="full", lr=3e-4, warmup_steps=max(1, min(200, total_steps // 10)),
                     total_steps=total_steps, checkpoint_every=1000, log_every=50)
    tr = Trainer(base, dit_cfg, tc, os.path.join(out, "train"), device=dev)
    if tr.resume():
        log(f"[train] resumed at step {tr.step}")
    ds = PreprocessedDataset(os.path.join(out, "dataset"))
    metrics = MetricsLogger(os.path.join(out, "train", "metrics.jsonl"))
    t0 = time.perf_counter()
    res = tr.train(ds.batches(batch_size, seed=1), max_steps=total_steps,
                   log_fn=lambda s: log(f"[train] {s}"), metrics=metrics)
    secs = time.perf_counter() - t0
    tr.save_checkpoint()
    path = tr.export("dit_trained")
    first = float(np.mean(tr.history[:50])) if len(tr.history) > 50 else float("nan")
    last = float(np.mean(tr.history[-50:])) if tr.history else float("nan")
    log(f"[train] done: {res['steps']} steps in {secs:.1f} s, loss {first:.4f} -> "
        f"{last:.4f} -> {path}")
    return {"steps": res["steps"], "seconds": secs, "first_loss": first, "last_loss": last,
            "history": list(tr.history)}


# ---------------------------------------------------------------------------
# phase eval
# ---------------------------------------------------------------------------

def eval_request() -> GenerationRequest:
    rng = np.random.default_rng(3)
    return GenerationRequest(duration_s=SONG_S,
                             style_token_ids=rng.integers(1, 500, (1, 12)),
                             lyric_token_ids=rng.integers(1, 500, (1, 16)),
                             seeds=[17])


VAE_NOTE_TRAINED = (
    "VAE leg: spectrally-TRAINED decoder (phase vae: shift-tolerant waveform MSE + "
    "multi-res STFT + latent-scale reg; its numbers in vae_trained_meta.json).  It is "
    "well-conditioned and trained on the latent distribution the DiT produces, the "
    "properties the quant gate needs (see the decoder-leg control below), but it is NOT a "
    "high-fidelity waveform autoencoder: pointwise phase reconstruction from scratch "
    "stays at the silence floor without adversarial/phase objectives.  The q8_0 row "
    "below therefore measures quantization-induced divergence through a smooth decoder, "
    "not through an arbitrary random amplifier.")
VAE_NOTE_RANDOM = "VAE leg: RANDOM decoder; waveform rows NOT meaningful (run --phase vae)."


def phase_eval(out: str, report_dir: str, *, cfgs=None, params=None,
               noise: Optional[torch.Tensor] = None, device=None,
               log: Callable[[str], None] = stderr_log,
               on_variant: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """The eval of ``<out>/train/dit_trained`` (cast from f32 to bf16) through
    the trained VAE (else the random one); writes the report and returns the
    summary (``rows``, ``decoder_control``, ``vae_trained``).  ``params``: the
    random (VAE, text encoder), drawn from ``TREE_SEEDS`` in bf16 when None;
    ``noise``: the initial latents; ``on_variant(name)`` is called after each
    variant's two requests."""
    dev = resolve_device(device)
    dit_cfg, vae_cfg, text_cfg = cfgs = cfgs or configs()
    if params is None:
        _, rand_vae_p, text_p = draw_trees(cfgs, dev, torch.bfloat16)
    else:
        rand_vae_p, text_p = params
    vae_p = load_trained_vae(out, dev)
    vae_trained = vae_p is not None
    if not vae_trained:
        log("[eval] WARNING: decoding through a RANDOM VAE: waveform metrics are not "
            "meaningful (run --phase vae)")
        vae_p = rand_vae_p
    trained = loader.load_params(os.path.join(out, "train", "dit_trained"), device=dev)
    fp_dit = tree_map(lambda a: a.to(torch.bfloat16) if a.dtype == torch.float32 else a,
                      trained)
    del trained
    os.makedirs(report_dir, exist_ok=True)
    req = eval_request()

    def run(name, dit_p):
        got = run_variant(name, dit_p, vae_p, text_p, cfgs, req, dev, report_dir,
                          noise, lambda m: log(f"[eval] {m}"))
        if on_variant is not None:
            on_variant(name)
        return got

    fp_wav, fp_lat, fp_s = run("fp_bf16", fp_dit)
    rows = [{"variant": "fp_bf16", "infer_s": fp_s}]
    q8_lat = None
    for fmt in EVAL_FORMATS:
        wav, lat, infer_s = run(fmt, quantized(fp_dit, fmt))
        rows.append({"variant": fmt, "infer_s": infer_s,
                     "metrics": quant_metrics(fp_wav, fp_lat, wav, lat)})
        if fmt == "q8_0":
            q8_lat = lat
    # the decoder-leg control: the same (bf16, q8_0) latent pair through each
    # decoder; the latent difference is the same by construction, so a gap
    # between the two rows is the decoder's alone
    decoder_rows = []
    if q8_lat is not None and vae_trained:
        pair = torch.from_numpy(np.stack([fp_lat, q8_lat])).to(dev)
        for dec_name, dec_p in (("trained", vae_p), ("random", rand_vae_p)):
            with torch.no_grad():
                wavs = vae.decode(dec_p, vae_cfg, pair).float().cpu().numpy()
            decoder_rows.append({"decoder": dec_name,
                                 "metrics": waveform_metrics(wavs[0], wavs[1])})
    summary = table(rows)
    if decoder_rows:
        summary += ("\n\n## Decoder-leg control: identical (fp, q8_0) latent pair through "
                    "each decoder\n\n| decoder | mae | rmse | cosine | snr_db | lsd |\n"
                    "|---|---:|---:|---:|---:|---:|\n")
        for r in decoder_rows:
            m = r["metrics"]
            summary += (f"| {r['decoder']} | {m['mae']:.6f} | {m['rmse']:.6f} "
                        f"| {m['cosine']:.6f} | {m['snr_db']:.2f} | {m['lsd']:.4f} |\n")
    with open(os.path.join(report_dir, "summary.md"), "w") as f:
        f.write("# Quant eval on TRAINED weights — half-scale flagship, "
                f"{SONG_S:.0f}s clip\n\n"
                "DiT trained on synthetic audio with the training stack "
                "(acestep_tpu_torch/train_quality_eval.py; the dataset and the loss log "
                "beside it under train/); metrics vs the trained fp_bf16 output, same "
                "seed and noise.  Reference gate: Q8_0 waveform cosine ~0.999, Q4_K "
                f"~0.93.  {device_line(dev)}.\n"
                f"{VAE_NOTE_TRAINED if vae_trained else VAE_NOTE_RANDOM}\n\n{summary}\n")
    result = {"rows": rows, "decoder_control": decoder_rows, "vae_trained": vae_trained}
    with open(os.path.join(report_dir, "summary.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(summary)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phase", default="all", choices=("vae", "data", "train", "eval", "all"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--report", default=None, help="default: <out>/report")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--vae-steps", type=int, default=3000)
    ap.add_argument("--vae-batch", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--songs", type=int, default=N_SONGS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.phase in ("vae", "all") and not os.path.exists(
            os.path.join(args.out, "vae_trained.json")):
        phase_vae(args.out, args.vae_steps, args.vae_batch, n_songs=args.songs,
                  device=args.device)
    if args.phase in ("data", "all") and not os.path.exists(
            os.path.join(args.out, "dataset", "manifest.json")):
        phase_data(args.out, n_songs=args.songs, device=args.device)
    if args.phase in ("train", "all"):
        phase_train(args.out, args.steps, args.batch_size, device=args.device)
    if args.phase in ("eval", "all"):
        phase_eval(args.out, args.report or os.path.join(args.out, "report"),
                   device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
