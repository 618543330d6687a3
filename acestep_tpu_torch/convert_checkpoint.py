"""Checkpoint converter of the port: reference safetensors checkpoints to the
port's quantized format, which ``serving/launch.build_engine`` serves.

    python -m acestep_tpu_torch.convert_checkpoint --dit DIR --vae DIR --text DIR \\
        [--lm DIR] --out OUT [--quant q4_k] [--lm-quant q8_0]

Each component directory holds ``model.safetensors`` (or
``diffusion_pytorch_model.safetensors``, or a single ``*.safetensors``) and,
where present, a ``config.json`` whose keys override the architecture's
defaults.  The flags are those of the JAX package's tools/convert_checkpoint.py.
The conversion runs on the host, one tensor at a time, and needs no card: the
kernels are quantized by the native C++ quantizers (``quant/native_bridge``),
as the JAX converter quantizes them.  It writes the JAX converter's bytes:
``OUT/<name>.safetensors`` and ``<name>.json`` (the parameters, see
``loader.save_params``), ``<name>.config.json`` (the resolved config),
``manifest.json`` and, with an LM, its ``tokenizer.json``.

The DiT checkpoint is probed for the audio-code bridge's tensors
(``models/codec``): where there are any they must load through one of its
architectures (pinned or renamed by a ``codec`` block of the DiT's
config.json: ``{"arch": ..., "name_map": {...}}``), or the conversion fails
with the names that did not map, unless ``--allow-random-codec`` records the
mismatch in the manifest instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

QUANTS = ("bf16", "q8_0", "q4_0", "q4_k", "q6_k")


def _find_st(path: str) -> str:
    if path.endswith(".safetensors"):
        return path
    for name in ("model.safetensors", "diffusion_pytorch_model.safetensors"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return p
    cands = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return os.path.join(path, cands[0])
    raise FileNotFoundError(f"no unambiguous .safetensors in {path}: {cands}")


def _source_config(path: str) -> dict:
    p = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if p and os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return {}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dit")
    ap.add_argument("--vae")
    ap.add_argument("--text")
    ap.add_argument("--lm")
    ap.add_argument("--out", required=True)
    ap.add_argument("--quant", default="q8_0", choices=QUANTS)
    ap.add_argument("--lm-quant", default=None, help="override quant for the LM")
    ap.add_argument("--allow-random-codec", action="store_true",
                    help="when the DiT checkpoint carries codec tensors that cannot be "
                         "mapped, keep the structural random-weight bridge instead of "
                         "failing (records the name diff in the manifest)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from acestep_tpu_torch import loader
    from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
    from acestep_tpu_torch.models import codec as codec_mod
    from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile

    os.makedirs(args.out, exist_ok=True)
    quant = None if args.quant == "bf16" else args.quant
    manifest = {"quant": args.quant, "components": {}}

    def convert(name, path, load_fn, cfg):
        t0 = time.time()
        params = load_fn(SafetensorsFile(_find_st(path)), cfg)
        loader.save_params(os.path.join(args.out, name), params,
                           {"component": name, "quant": args.quant})
        # the resolved config, so serving needs no access to the source directory
        with open(os.path.join(args.out, f"{name}.config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1)
        dt = time.time() - t0
        manifest["components"][name] = {"source": path, "seconds": round(dt, 1)}
        print(f"{name}: converted in {dt:.1f}s", file=sys.stderr)

    if args.dit:
        src_cfg = _source_config(args.dit)
        convert("dit", args.dit,
                lambda st, c: loader.load_dit(st, c, quant=quant),
                DiTConfig.from_dict(src_cfg))
        st = SafetensorsFile(_find_st(args.dit))
        probe = codec_mod.probe_tensor_names(st.keys())
        manifest["codec_probe"] = [{"name": n, "shape": list(st.info(n)[1])} for n in probe]
        override = src_cfg.get("codec", {})
        if probe:
            try:
                codec_params = codec_mod.load_from_checkpoint(
                    st, name_map=override.get("name_map"), arch=override.get("arch"))
            except codec_mod.CodecMismatchError as e:
                if not args.allow_random_codec:
                    print(f"codec: FAILED\n{e}", file=sys.stderr)
                    return 1
                manifest["components"]["codec"] = {"status": "random", "mismatch": str(e)}
                print(f"codec: unmapped, keeping structural bridge "
                      f"(--allow-random-codec)\n{e}", file=sys.stderr)
            else:
                arch_name, _ = codec_mod.get_arch(codec_params)
                loader.save_params(os.path.join(args.out, "codec"), codec_params,
                                   {"component": "codec", "quant": "f32", "arch": arch_name})
                with open(os.path.join(args.out, "codec.config.json"), "w") as f:
                    json.dump({"source_names": probe, "arch": arch_name,
                               "name_map": override.get("name_map", {})}, f, indent=1)
                manifest["components"]["codec"] = {"source": args.dit, "tensors": len(probe),
                                                   "arch": arch_name}
                print(f"codec: loaded {len(probe)} checkpoint tensors (arch {arch_name})",
                      file=sys.stderr)
    if args.vae:
        convert("vae", args.vae, lambda st, c: loader.load_vae(st, c),
                VAEConfig.from_dict(_source_config(args.vae)))
    if args.text:
        convert("text_encoder", args.text,
                lambda st, c: loader.load_qwen(st, c, quant=quant),
                QwenConfig.from_dict(_source_config(args.text)))
    if args.lm:
        lm_quant = args.lm_quant or quant
        convert("lm", args.lm,
                lambda st, c: loader.load_qwen(st, c, quant=lm_quant),
                QwenConfig.from_dict(_source_config(args.lm)))
        # the tokenizer beside the weights: serving/launch.build_lm reads it
        tok_src = os.path.join(args.lm, "tokenizer.json")
        if os.path.isdir(args.lm) and os.path.exists(tok_src):
            shutil.copyfile(tok_src, os.path.join(args.out, "tokenizer.json"))
            manifest["components"]["tokenizer"] = {"source": tok_src}

    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps(manifest))
    return 0


if __name__ == "__main__":
    sys.exit(main())
