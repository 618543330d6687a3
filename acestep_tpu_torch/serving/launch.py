"""Server entry point of the port: build the engine (and the LM planner) and
put the REST or the OpenRouter server in front of it.  Port of the JAX
package's serving/launch.py.

    python -m acestep_tpu_torch.serving.launch api        [--port 8000] [--checkpoint DIR]
    python -m acestep_tpu_torch.serving.launch openrouter [--port 8001] [--checkpoint DIR]

``--device`` (default ``cuda``) picks where the engine runs.  Without
``--checkpoint`` a full-width random-weight engine is built at ``--quant``
(demo mode; LoRA stays off, having no checkpoint tree).

A checkpoint directory holds ``dit``, ``vae`` and ``text_encoder`` parameter
files as ``loader.save_params`` writes them (``<name>.safetensors`` plus
``<name>.json``), each beside an optional ``<name>.config.json`` (the model's
config; the flagship defaults where it is missing).  Quantized weights are
served in the format they were saved in.  An LM planner adds ``lm`` parameter
files, ``lm.config.json`` and the tokenizer's ``tokenizer.json`` (read with the
``tokenizers`` package); the audio-code bridge adds ``codec`` parameter files
(``models/codec``'s tree as ``loader.save_params`` writes it).  With an LM the
server runs the whole ``inference.generate_music`` (``make_full_generate_fn``),
else the engine alone (``make_generate_fn``).

Payloads are the studio UI's (``serving/api_server.RequestParser`` reads
their aliases).  Audio uploads (``src_audio_base64``, ``refer_audio_base64``:
WAV, FLAC or MP3, base64 or a data URL) are decoded on the host and
VAE-encoded by the engine.  The REST server carries a
``TrainingManager`` (``/v1/training/*``: jobs on ``--device``, reading a
dataset directory and a ``checkpoint_dir`` with ``dit`` files and a
``config.json``) and a ``DatasetManager`` (``/v1/dataset/*``: scan, LM
labeling where an LM is loaded, preprocessing through this engine).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import secrets
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.lm_pipeline import LMPipeline, TokenizerJsonAdapter
from acestep_tpu_torch.pipeline import AceStepEngine, build_random_engine, resolve_device


def _load_cfg(checkpoint: str, name: str, cls):
    path = os.path.join(checkpoint, f"{name}.config.json")
    if not os.path.exists(path):
        return cls()
    with open(path) as f:
        return cls.from_dict(json.load(f))


def build_engine(checkpoint: Optional[str] = None, quant: str = "q8_0",
                 device=None, *, dit_mega: bool = False, int8_act: bool = False, mesh=None):
    """(engine, unstacked DiT tree) of ``checkpoint`` on ``device`` (the card
    by default).  The tree is the checkpoint's ``dit`` files as read, which
    ``lora_runtime.LoRARuntime`` merges adapters into.  Without a checkpoint:
    a full-width random-weight engine quantized to ``quant`` (``"bf16"`` for
    none), and None for the tree.  ``dit_mega`` / ``int8_act`` / ``mesh`` as
    :class:`AceStepEngine` (under a mesh, on the mesh's device unless
    ``device`` is given; every rank reads the whole files and keeps its
    shards)."""
    if not checkpoint:
        return build_random_engine(device=device, quant=None if quant == "bf16" else quant,
                                   dit_mega=dit_mega, int8_act=int8_act, mesh=mesh), None
    dev = resolve_device(device, mesh)

    def params(name):
        return loader.load_params(os.path.join(checkpoint, name), device=dev)

    dit_params = params("dit")
    engine = AceStepEngine(dit_params, _load_cfg(checkpoint, "dit", DiTConfig),
                           params("vae"), _load_cfg(checkpoint, "vae", VAEConfig),
                           params("text_encoder"),
                           _load_cfg(checkpoint, "text_encoder", QwenConfig), device=dev,
                           dit_mega=dit_mega, int8_act=int8_act, mesh=mesh)
    return engine, dit_params


def build_lm(checkpoint: Optional[str], device=None, mesh=None,
             **knobs) -> Optional[LMPipeline]:
    """The LM planner of ``checkpoint`` on ``device`` (the card by default):
    ``lm`` parameters, ``lm.config.json`` and ``tokenizer.json``.  None when the
    checkpoint has no LM: the server then runs the engine alone.  ``mesh`` and
    ``knobs`` go to :class:`LMPipeline`."""
    if not checkpoint:
        return None
    lm_dir = os.path.join(checkpoint, "lm")
    tok_path = os.path.join(checkpoint, "tokenizer.json")
    if not os.path.exists(lm_dir + ".safetensors") or not os.path.exists(tok_path):
        return None
    with open(os.path.join(checkpoint, "lm.config.json")) as f:
        cfg = QwenConfig.from_dict(json.load(f))
    dev = resolve_device(device, mesh)
    return LMPipeline(loader.load_params(lm_dir, device=dev), cfg,
                      TokenizerJsonAdapter(tok_path), device=dev, mesh=mesh, **knobs)


def build_codec(checkpoint: Optional[str], device=None):
    """The codec bridge's parameters of ``checkpoint`` (``codec.safetensors`` and
    ``codec.json``) on ``device`` (the card by default); None when the
    checkpoint carries none, and the LM code hints then stay off."""
    if not checkpoint:
        return None
    codec_dir = os.path.join(checkpoint, "codec")
    if not os.path.exists(codec_dir + ".safetensors"):
        return None
    return loader.load_params(codec_dir, device=resolve_device(device))


# ---------------------------------------------------------------------------
# audio uploads
# ---------------------------------------------------------------------------

def _decode_audio_payload(b64: str, fmt: str = "") -> np.ndarray:
    """base64 (or data-URL) audio -> [L, C] float32.  WAV and FLAC decode with
    numpy (utils.audio, utils.flac), MP3 through libmpg123 (utils.mp3); the
    format is sniffed from the magic bytes when not given."""
    if b64.startswith("data:"):
        b64 = b64.split(",", 1)[1]
    data = base64.b64decode(b64)
    fmt = (fmt or "").lower()
    if not fmt:
        if data[:4] == b"fLaC":
            fmt = "flac"
        elif data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF
                                    and (data[1] & 0xE0) == 0xE0):
            fmt = "mp3"
        else:
            fmt = "wav"
    if fmt == "flac":
        from acestep_tpu_torch.utils.flac import decode_flac

        audio, _ = decode_flac(data)
        return np.asarray(audio, np.float32)
    if fmt == "mp3":
        from acestep_tpu_torch.utils import mp3

        if not mp3.decoder_available():
            raise ValueError("mp3 upload received but libmpg123 is not available on this "
                             "host — upload wav or flac instead")
        audio, _ = mp3.decode_mp3_bytes(data)
        return np.asarray(audio, np.float32)
    from acestep_tpu_torch.utils.audio import read_wav_bytes

    audio, _ = read_wav_bytes(data)
    return audio


def _parse_audio_inputs(p, payload, engine, req_kwargs: Dict[str, Any]) -> None:
    """Fill ``src_latents`` / ``refer_latents`` and the repaint span from the
    upload fields: the source audio of repaint / cover / extract / lego /
    complete, the reference audio of the timbre."""
    src_b64 = p.str("src_audio_base64") or p.str("source_audio_base64")
    if src_b64:
        audio = _decode_audio_payload(src_b64, p.str("src_audio_format"))
        req_kwargs["src_latents"] = engine.encode_src_audio(audio)
        # the duration defaults to the source's whole latent frames
        if not payload.get("duration") and not payload.get("audioDuration"):
            hop = engine.vae_cfg.hop_length
            req_kwargs["duration_s"] = audio.shape[0] // hop * hop / engine.vae_cfg.sampling_rate
    ref_b64 = p.str("refer_audio_base64") or p.str("reference_audio_base64")
    if ref_b64:
        audio = _decode_audio_payload(ref_b64, p.str("refer_audio_format"))
        req_kwargs["refer_latents"] = engine.encode_refer_audio([audio])
        req_kwargs["refer_mask"] = np.ones(req_kwargs["refer_latents"].shape[:2], np.int32)
    if payload.get("repaint_start") is not None:
        req_kwargs["repaint_start_s"] = p.float("repaint_start", 0.0)
    if payload.get("repaint_end") is not None:
        req_kwargs["repaint_end_s"] = p.float("repaint_end", -1.0)
    if p.str("track_name"):
        req_kwargs["track_name"] = p.str("track_name")


def _byte_ids(text: str, cap: int):
    """Demo-mode token ids (real deployments pass a tokenizer): the text's
    bytes, [1, <= cap]."""
    ids = [b % 32000 for b in text.encode()][:cap]
    return np.asarray([ids], np.int32)


# ---------------------------------------------------------------------------
# payload -> result functions
# ---------------------------------------------------------------------------

def build_request(engine, payload: Dict[str, Any], tokenizer=None):
    """(GenerationRequest, RequestParser, lyric ids) of a payload, uploads
    encoded: what ``make_generate_fn``'s function hands the engine."""
    from acestep_tpu_torch.pipeline import GenerationRequest
    from acestep_tpu_torch.serving.api_server import RequestParser

    def tokenize(text: str, cap: int):
        if tokenizer is not None:
            ids = tokenizer.encode(text)[:cap]
            return np.asarray([ids], np.int32) if ids else None
        return _byte_ids(text, cap) if text else None

    p = RequestParser(payload)
    lyric_ids = tokenize(p.str("lyrics"), 2048)
    req_kwargs: Dict[str, Any] = dict(
        duration_s=p.float("duration", 30.0),
        style_token_ids=tokenize(p.str("caption"), 256),
        lyric_token_ids=lyric_ids,
        task=p.str("task_type", "text2music"),
        seeds=[p.int("seed", 0)],
        shift=p.float("shift", 3.0) if payload.get("shift") else 3.0,
        infer_method=p.str("infer_method", "ode"),
        batch_size=p.int("batch_size", 1),
        audio_cover_strength=p.float("audio_cover_strength", 1.0),
        guidance_scale=p.float("guidance_scale", 1.0),
        infer_steps=p.int("inference_steps", 8),
        use_adg=p.bool("use_adg"),
    )
    _parse_audio_inputs(p, payload, engine, req_kwargs)
    return GenerationRequest(**req_kwargs), p, lyric_ids


def make_generate_fn(engine, tokenizer=None):
    """payload dict -> result dict through ``engine.generate``: the audio as
    base64 WAV, FLAC or MP3 (``audio_format``; MP3 falls back to WAV without
    libmp3lame), metadata and timings; with ``return_lrc`` and lyrics, the LRC,
    the token timestamps and the alignment score too."""

    def generate(payload: Dict[str, Any]) -> Dict[str, Any]:
        from acestep_tpu_torch.utils.audio import wav_bytes
        from acestep_tpu_torch.utils.flac import encode_flac

        req, p, lyric_ids = build_request(engine, payload, tokenizer)
        res = engine.generate(req)
        # the engine's peak-normalized 16-bit PCM; segments pass through whole
        segments = [s[0] for s in res.pcm16_segments()]
        fmt = p.str("audio_format", "wav").lower()
        if fmt == "mp3":
            from acestep_tpu_torch.utils import mp3

            if mp3.encoder_available():
                audio = segments[0] if len(segments) == 1 else np.concatenate(segments, axis=0)
                audio_b64 = base64.b64encode(mp3.encode_mp3(audio, res.sample_rate)).decode()
            else:
                fmt = "wav"                     # AudioSaver's fallback
        if fmt == "flac":
            audio = segments[0] if len(segments) == 1 else np.concatenate(segments, axis=0)
            audio_b64 = base64.b64encode(encode_flac(audio, res.sample_rate)).decode()
        elif fmt != "mp3":
            fmt = "wav"
            audio_b64 = base64.b64encode(wav_bytes(segments, res.sample_rate)).decode()
        out = {
            "audio_base64": audio_b64,
            "audio_format": fmt,
            "sample_rate": res.sample_rate,
            "metadata": {k: p.get(k) for k in ("caption", "bpm", "duration", "keyscale")
                         if p.get(k)},
            "time_costs": {k: round(v, 3) for k, v in res.time_costs.items()},
            "seeds": res.seeds,
        }
        if p.bool("return_lrc") and lyric_ids is not None:
            lyrics = p.str("lyrics")
            lines = [ln for ln in lyrics.split("\n") if ln.strip()]
            n_ids = int(lyric_ids.shape[1])
            per = max(1, n_ids // max(1, len(lines)))
            counts = [per] * len(lines)
            counts[-1] = n_ids - per * (len(lines) - 1)
            stamps, lrc = engine.get_lyric_timestamps(
                res.latents, req, lyric_lines=lines, line_token_counts=counts)
            out["lrc"] = lrc
            out["lyric_timestamps"] = [round(float(s), 3) for s in stamps]
            out["lyric_score"] = float(engine.get_lyric_score(res.latents, req))
        return out

    return generate


def build_params(engine, payload: Dict[str, Any], tok=None):
    """(GenerationParams, GenerationConfig) of a payload, uploads encoded:
    what ``make_full_generate_fn``'s function hands ``generate_music``."""
    from acestep_tpu_torch.inference import GenerationConfig, GenerationParams
    from acestep_tpu_torch.serving.api_server import RequestParser

    def tokenize(text: str, cap: int):
        if not text:
            return None
        if tok is not None:
            ids = tok.encode(text)[:cap]
            return np.asarray([ids], np.int32) if ids else None
        return _byte_ids(text, cap)

    p = RequestParser(payload)
    caption, lyrics = p.str("caption"), p.str("lyrics")
    params = GenerationParams(
        caption=caption,
        lyrics=lyrics,
        bpm=p.int("bpm") or None,
        keyscale=p.str("keyscale"),
        timesignature=p.str("timesignature"),
        duration=p.float("duration", -1.0),
        language=p.str("language"),
        task_type=p.str("task_type", "text2music"),
        thinking=p.bool("thinking", True),
        lm_temperature=p.float("lm_temperature", 0.85),
        lm_metadata_temperature=p.float("lm_metadata_temperature"),
        lm_codes_temperature=p.float("lm_codes_temperature"),
        lm_top_p=p.float("lm_top_p", 0.95),
        lm_top_k=p.int("lm_top_k", 0),
        lm_cfg_scale=p.float("lm_cfg_scale", 1.0),
        lm_negative_prompt=p.str("lm_negative_prompt", "NO USER INPUT"),
        lm_num_candidates=p.int("lm_num_candidates", 1),
        lm_constrained_cot=p.bool("constrained_decoding", True),
        inference_steps=p.int("inference_steps", 8),
        shift=p.float("shift", 3.0),
        infer_method=p.str("infer_method", "ode"),
        audio_cover_strength=p.float("audio_cover_strength", 1.0),
        style_token_ids=tokenize(caption, 256),
        lyric_token_ids=tokenize(lyrics, 2048),
    )
    # uploads: the engine-only function's fields (GenerationParams names the
    # repaint span without the _s)
    audio_kwargs: Dict[str, Any] = {}
    _parse_audio_inputs(p, payload, engine, audio_kwargs)
    if "src_latents" in audio_kwargs:
        params.src_latents = audio_kwargs["src_latents"]
    if "refer_latents" in audio_kwargs:
        params.refer_latents = audio_kwargs["refer_latents"]
    if "repaint_start_s" in audio_kwargs:
        params.repaint_start = audio_kwargs["repaint_start_s"]
    if "repaint_end_s" in audio_kwargs:
        params.repaint_end = audio_kwargs["repaint_end_s"]
    if "track_name" in audio_kwargs:
        params.track_name = audio_kwargs["track_name"]
    if "duration_s" in audio_kwargs and params.duration < 0:
        params.duration = audio_kwargs["duration_s"]
    config = GenerationConfig(batch_size=p.int("batch_size", 1), seeds=[p.int("seed", 0)],
                              lm_batch_chunk_size=p.int("lm_batch_chunk_size", 4))
    return params, config


def make_full_generate_fn(engine, lm, codec_params=None, tokenizer=None):
    """payload dict -> result dict through the whole ``inference.generate_music``:
    the LM's CoT and codes, the metadata merge, the code hints (with
    ``codec_params``), the DiT and the decode; WAV out, the CoT text beside."""
    from acestep_tpu_torch.inference import generate_music

    tok = tokenizer if tokenizer is not None else getattr(lm, "tok", None)

    def generate(payload: Dict[str, Any]) -> Dict[str, Any]:
        from acestep_tpu_torch.utils.audio import wav_bytes

        params, config = build_params(engine, payload, tok)
        res = generate_music(engine, lm, params, config, codec_params=codec_params)
        segments = [s[0] for s in res.dit_result.pcm16_segments()]
        return {
            "audio_base64": base64.b64encode(wav_bytes(segments, res.sample_rate)).decode(),
            "audio_format": "wav",
            "sample_rate": res.sample_rate,
            "metadata": res.metadata,
            "cot_text": res.lm_result.cot_text if res.lm_result else "",
            "time_costs": {k: round(v, 3) for k, v in res.time_costs.items()},
            "seeds": res.seeds,
        }

    return generate


def openrouter_generate_fn(generate):
    """The OpenRouter server's function over a payload function: the parsed
    chat message as a payload, the WAV read back to float audio."""
    from acestep_tpu_torch.utils.audio import read_wav_bytes

    def or_generate(parsed):
        out = generate({**parsed["metadata"], "caption": parsed["caption"],
                        "lyrics": parsed["lyrics"]})
        audio, sr = read_wav_bytes(base64.b64decode(out["audio_base64"]))
        return {"audio": audio, "sample_rate": sr, "metadata": out["metadata"]}

    return or_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["api", "openrouter"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--quant", default=os.environ.get("ACESTEP_TPU_QUANT", "q8_0"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"building engine (quant={args.quant}, checkpoint={args.checkpoint}, "
          f"device={args.device})...", file=sys.stderr)
    engine, dit_base_params = build_engine(args.checkpoint, args.quant, device=args.device)
    lm = build_lm(args.checkpoint, device=args.device)
    generate = (make_full_generate_fn(engine, lm,
                                      codec_params=build_codec(args.checkpoint, args.device))
                if lm is not None else make_generate_fn(engine))

    if args.mode == "api":
        from acestep_tpu_torch.serving.api_server import ApiServer
        from acestep_tpu_torch.serving.dataset_manager import DatasetManager
        from acestep_tpu_torch.serving.training_manager import TrainingManager

        lora_rt = None
        if dit_base_params is not None:
            # adapters merge into the checkpoint's unstacked tree; demo mode
            # (random weights) has none, so the LoRA routes stay off
            from acestep_tpu_torch.lora_runtime import LoRARuntime

            lora_rt = LoRARuntime(engine, dit_base_params)

        def fresh_seed(fn):
            # the inspiration flow samples anew on every call
            return lambda text: fn(text, seed=secrets.randbelow(2**31))

        srv = ApiServer(generate,
                        create_sample_fn=(fresh_seed(lm.create_sample_from_query)
                                          if lm is not None else None),
                        format_input_fn=(fresh_seed(lm.format_sample_from_input)
                                         if lm is not None else None),
                        lora_runtime=lora_rt,
                        training_manager=TrainingManager(device=args.device),
                        dataset_manager=DatasetManager(
                            engine, lm=lm,
                            codec_params=build_codec(args.checkpoint, args.device)))
        port = srv.start(args.host, args.port or 8000)
        print(f"API + studio at http://{args.host}:{port}/  (POST /release_task)")
    else:
        from acestep_tpu_torch.serving.openrouter_server import OpenRouterServer

        srv = OpenRouterServer(openrouter_generate_fn(generate))
        port = srv.start(args.host, args.port or 8001)
        print(f"OpenRouter API at http://{args.host}:{port}/v1/chat/completions")

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
