"""acestep-tpu-torch CLI: the engine's modes from the command line (port of
the repository's root cli.py, on the port's engine).

    python -m acestep_tpu_torch.cli --pipeline-style-lyric --audio-seconds 10 --out x.wav

  --text-encoder     the style branch (Qwen text encoder + text projector) on a
                     token file: shape and stats
  --dit              one DiT forward on random latents (the second call timed)
  --vae              VAE decode of random latents -> WAV
  --pipeline         text2music from a style token file
  --pipeline-style-lyric         style + lyric token files
  --pipeline-style-lyric-timbre  + reference latents (.npy [n, L, 64])
  --wizard           interactive prompts, then --pipeline

Token files hold whitespace-separated integer token ids.  Without
--checkpoint the engine has random weights (``build_random_engine`` at
--quant); with it, a converted checkpoint directory (``serving.launch.
build_engine``).  Each mode prints one JSON line last.  ``--device`` is where
the engine runs: the card by default.  The weight format is --quant, else
the layered settings' (``settings.Settings``: ACESTEP_TPU_QUANT, a ``.env``
file); the engine's switches come from there too (ACESTEP_TPU_DIT_MEGA,
ACESTEP_TPU_INT8_ACT) and pass to the engine builders as arguments.

Under ``torchrun`` (WORLD_SIZE set) the pipeline modes serve from a (dp, tp)
mesh over the ranks, one card a rank (``parallel.distributed``; dp and tp
from ``settings.Settings.load(n_devices=, local_devices=)``: the tier's tp
clamped to one host's ranks, dp the rest):
every rank runs the same request and rank 0 writes the file and prints:

    torchrun --nproc-per-node 2 -m acestep_tpu_torch.cli --pipeline-style-lyric --out x.wav
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from acestep_tpu_torch import pipeline
from acestep_tpu_torch.parallel import distributed, make_mesh
from acestep_tpu_torch.settings import Settings


def _read_token_file(path: str) -> np.ndarray:
    with open(path) as f:
        ids = [int(tok) for tok in f.read().split()]
    return np.asarray([ids], dtype=np.int32)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--text-encoder", action="store_true")
    mode.add_argument("--dit", action="store_true")
    mode.add_argument("--vae", action="store_true")
    mode.add_argument("--pipeline", action="store_true")
    mode.add_argument("--pipeline-style-lyric", action="store_true")
    mode.add_argument("--pipeline-style-lyric-timbre", action="store_true")
    mode.add_argument("--wizard", action="store_true", help="interactive prompt flow")
    ap.add_argument("--style-tokens", type=str, help="style token file")
    ap.add_argument("--lyric-tokens", type=str, help="lyric token file")
    ap.add_argument("--timbre-npy", type=str, help="reference latents .npy [n, L, 64]")
    ap.add_argument("--timbre-rand-n", type=int, default=0, help="random timbre clips")
    ap.add_argument("--audio-seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shift", type=float, default=3.0)
    ap.add_argument("--infer-method", choices=["ode", "sde"], default="ode")
    ap.add_argument("--quant", choices=["bf16", "q8_0", "q4_0", "q4_k", "q6_k"], default=None)
    ap.add_argument("--checkpoint", type=str, help="converted checkpoint directory")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default="output.wav")
    return ap


def _engine(args, settings: Settings, mesh=None):
    # under a mesh each rank's device is the mesh's
    kw = dict(device=args.device) if mesh is None else dict(mesh=mesh)
    if args.checkpoint:
        from acestep_tpu_torch.serving.launch import build_engine

        engine, _ = build_engine(args.checkpoint, settings.quant, dit_mega=settings.dit_mega,
                                 int8_act=settings.int8_act, **kw)
        return engine
    quant = None if settings.quant == "bf16" else settings.quant
    return pipeline.build_random_engine(quant=quant, seed=0, dit_mega=settings.dit_mega,
                                        int8_act=settings.int8_act, **kw)


def _mesh(args, settings: Settings):
    """The (dp, tp) mesh under torchrun, else None (one process)."""
    if not distributed.initialize():
        return None
    if args.text_encoder or args.vae or args.dit:
        raise SystemExit("under torchrun the CLI runs the pipeline modes")
    return make_mesh(dp=settings.dp, tp=settings.tp)


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


@torch.no_grad()
def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.wizard:
        return run_wizard(args)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    settings = Settings.load(quant=args.quant, n_devices=world if world > 1 else None,
                             local_devices=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    mesh = _mesh(args, settings) if world > 1 else None

    from acestep_tpu_torch.models import dit as dit_mod
    from acestep_tpu_torch.models import qwen
    from acestep_tpu_torch.models import vae as vae_mod
    from acestep_tpu_torch.utils.audio import write_wav

    t0 = time.time()
    engine = _engine(args, settings, mesh)
    _sync(engine)
    print(f"load: {time.time() - t0:.2f}s (device={engine.device}, quant={settings.quant})",
          file=sys.stderr)
    dev = engine.device
    rng = np.random.default_rng(args.seed)
    style = (_read_token_file(args.style_tokens) if args.style_tokens
             else rng.integers(0, 150000, (1, 64)).astype(np.int32))
    lyric = _read_token_file(args.lyric_tokens) if args.lyric_tokens else None

    if args.text_encoder:
        ids = torch.from_numpy(style).to(dev)
        out = dit_mod.text_projector(engine.dit_params, qwen.forward(
            engine.text_params, engine.text_cfg, ids, torch.ones_like(ids)))
        arr = out.float().cpu().numpy()
        print(json.dumps({"mode": "text-encoder", "shape": list(arr.shape),
                          "mean": float(arr.mean()), "std": float(arr.std())}))
        return 0

    if args.vae:
        frames = int(round(args.audio_seconds * 25))
        lat = rng.standard_normal((1, frames, engine.vae_cfg.decoder_input_channels))
        lat = torch.from_numpy(lat.astype(np.float32)).to(dev)
        i16, _scale = vae_mod.fused_tiled_decode_int16(engine.vae_params, engine.vae_cfg, lat,
                                                       chunk_frames=128)
        audio = i16.cpu().numpy().reshape(1, -1, engine.vae_cfg.audio_channels)[0]
        write_wav(args.out, audio, engine.vae_cfg.sampling_rate)
        print(json.dumps({"mode": "vae", "samples": int(audio.shape[0]), "out": args.out}))
        return 0

    if args.dit:
        frames = int(round(args.audio_seconds * 25))
        cfg = engine.dit_cfg

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                dev, torch.bfloat16)

        hs = randn(1, frames, cfg.audio_acoustic_hidden_dim)
        ctx = randn(1, frames, cfg.context_dim)
        enc = randn(1, 64, cfg.hidden_size)
        t = torch.tensor([0.9], dtype=torch.float32, device=dev)

        def fwd():
            kv = dit_mod.compute_all_cross_kv(
                engine.dit_params, cfg, dit_mod.compute_condition(engine.dit_params, cfg, enc))
            return dit_mod.forward(engine.dit_params, cfg, hs, t, t, ctx, kv,
                                   dit_mega=engine.dit_mega, int8_act=engine.int8_act)

        fwd()
        _sync(engine)
        t1 = time.time()
        fwd()
        _sync(engine)
        print(json.dumps({"mode": "dit", "frames": frames,
                          "forward_s": round(time.time() - t1, 4)}))
        return 0

    req = pipeline.GenerationRequest(duration_s=args.audio_seconds, style_token_ids=style,
                                     seeds=[args.seed], shift=args.shift,
                                     infer_method=args.infer_method)
    if args.pipeline_style_lyric or args.pipeline_style_lyric_timbre:
        req.lyric_token_ids = (lyric if lyric is not None
                               else rng.integers(0, 150000, (1, 128)).astype(np.int32))
    if args.pipeline_style_lyric_timbre:
        if args.timbre_npy:
            req.refer_latents = np.load(args.timbre_npy)[None, ...]
        else:
            n = max(1, args.timbre_rand_n)
            req.refer_latents = rng.standard_normal(
                (1, n, 750, engine.dit_cfg.timbre_hidden_dim)).astype(np.float32)
    res = engine.generate(req)
    if mesh is not None:
        primary = distributed.is_primary()
        torch.distributed.destroy_process_group()
        if not primary:
            return 0        # every rank computed the same result; rank 0 writes it
    write_wav(args.out, [s[0] for s in res.pcm16_segments()], res.sample_rate)
    print(json.dumps({
        "mode": "pipeline",
        "out": args.out,
        "samples": int(sum(s.shape[1] for s in res.pcm16_segments())),
        "time_costs": {k: round(v, 3) for k, v in res.time_costs.items()},
        "seeds": res.seeds,
    }))
    return 0


def edit_formatted_prompt(caption, lyrics, editor=None):
    """Round-trip caption / lyrics through $EDITOR as a formatted prompt file;
    an aborted edit returns the inputs unchanged."""
    import subprocess

    editor = editor or os.environ.get("EDITOR", "vi")
    doc = f"# caption (one line)\n{caption}\n\n# lyrics\n{lyrics}\n"
    with tempfile.NamedTemporaryFile("w", suffix=".prompt.txt", delete=False) as f:
        f.write(doc)
        path = f.name
    try:
        if subprocess.call([*editor.split(), path]) != 0:
            return caption, lyrics
        with open(path) as f:
            lines = f.read().splitlines()
    finally:
        os.unlink(path)
    section, cap_lines, lyr_lines = None, [], []
    for ln in lines:
        low = ln.strip().lower()
        if low.startswith("# caption"):
            section = "caption"
        elif low.startswith("# lyrics"):
            section = "lyrics"
        elif section == "caption" and ln.strip():
            cap_lines.append(ln.strip())
        elif section == "lyrics":
            lyr_lines.append(ln)
    return " ".join(cap_lines) or caption, "\n".join(lyr_lines).strip()


def run_wizard(args) -> int:
    """Prompts for caption, lyrics and settings (defaults from a TOML file named
    by ACESTEP_TPU_CLI_CONFIG, else ``acestep_cli.toml``), then --pipeline with
    the caption's bytes as its style tokens."""
    import tomllib

    cfg = {}
    cfg_path = os.environ.get("ACESTEP_TPU_CLI_CONFIG", "acestep_cli.toml")
    if os.path.exists(cfg_path):
        with open(cfg_path, "rb") as f:
            cfg = tomllib.load(f)
        print(f"loaded config from {cfg_path}", file=sys.stderr)

    def ask(prompt, default=""):
        try:
            val = input(f"{prompt} [{default}]: ").strip()
        except EOFError:
            val = ""
        return val or default

    caption = ask("Caption / style", cfg.get("caption", "dreamy synthwave"))
    lyrics = ask("Lyrics (blank = instrumental)", cfg.get("lyrics", ""))
    if ask("Edit formatted prompt in $EDITOR? (y/N)", "n").lower().startswith("y"):
        caption, lyrics = edit_formatted_prompt(caption, lyrics)
    duration = float(ask("Duration seconds", str(cfg.get("duration", 30))))
    seed = int(ask("Seed", str(cfg.get("seed", 0))))
    out = ask("Output wav", cfg.get("out", "output.wav"))
    quant = ask("Quant (bf16/q8_0/q4_0/q4_k/q6_k)", cfg.get("quant", "q8_0"))
    argv = ["--pipeline", "--audio-seconds", str(duration), "--seed", str(seed),
            "--out", out, "--quant", quant, "--device", args.device]
    print(f"-> caption={caption!r} lyrics={len(lyrics)} chars; running pipeline...",
          file=sys.stderr)
    ids = [str(b % 32000) for b in caption.encode()][:256]
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(" ".join(ids))
        style_file = f.name
    try:
        return main(argv + ["--style-tokens", style_file])
    finally:
        os.unlink(style_file)


if __name__ == "__main__":
    sys.exit(main())
