"""Dataset builder, scan and label stages: port of the JAX package's
training/dataset_builder.py.

  1. scan  - walk a directory for audio files (WAV, FLAC) with caption and
             lyrics sidecars and an optional metadata.csv (a ``.txt`` /
             ``.caption`` sidecar is the caption, ``.lyrics`` / ``.lrc`` the
             lyrics; csv columns override);
  2. label - caption a sample with the LM: audio -> VAE latents -> 5 Hz codes
             (the codec's ``tokenize``) -> ``understand_audio_from_codes`` ->
             metadata fields (sidecar and csv fields win);
  3. preprocess / serialize - training/data.py.

WAV is read with ``utils.audio.read_wav``, FLAC with ``utils.flac.decode_flac``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from acestep_tpu_torch.lm_pipeline import indices_to_codes
from acestep_tpu_torch.models import codec, vae
from acestep_tpu_torch.utils.audio import read_wav
from acestep_tpu_torch.utils.flac import decode_flac

SUPPORTED_AUDIO_FORMATS = (".wav", ".flac")


@dataclasses.dataclass
class AudioSample:
    audio_path: str
    filename: str
    duration_s: float = 0.0
    caption: str = ""
    lyrics: str = ""
    is_instrumental: bool = False
    bpm: Optional[int] = None
    keyscale: str = ""
    timesignature: str = ""
    language: str = ""
    genres: str = ""
    labeled: bool = False


def _load_sidecar(audio_path: str, exts) -> str:
    root = os.path.splitext(audio_path)[0]
    for ext in exts:
        p = root + ext
        if os.path.exists(p):
            try:
                with open(p, encoding="utf-8") as f:
                    return f.read().strip()
            except OSError:
                pass
    return ""


def _load_csv_metadata(directory: str) -> Dict[str, Dict[str, str]]:
    """metadata.csv keyed by filename (``filename`` or ``file`` column)."""
    path = os.path.join(directory, "metadata.csv")
    table: Dict[str, Dict[str, str]] = {}
    if not os.path.exists(path):
        return table
    try:
        with open(path, newline="", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                name = row.get("filename") or row.get("file") or ""
                if name:
                    table[name] = {k: (v or "") for k, v in row.items()}
    except (OSError, csv.Error):
        pass
    return table


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """(waveform [L, C] f32, sample rate) of a WAV or FLAC file."""
    if path.lower().endswith(".flac"):
        with open(path, "rb") as f:
            return decode_flac(f.read())
    return read_wav(path)


def scan_directory(directory: str) -> List[AudioSample]:
    """Stage 1: every readable audio file under ``directory`` (sorted), with
    its sidecars and csv row."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    files = []
    for root, _, names in os.walk(directory):
        for name in sorted(names):
            if os.path.splitext(name)[1].lower() in SUPPORTED_AUDIO_FORMATS:
                files.append(os.path.join(root, name))
    files.sort()
    csv_meta = _load_csv_metadata(directory)

    samples = []
    for path in files:
        try:
            audio, sr = read_audio(path)
        except (OSError, ValueError, AssertionError):
            continue
        duration = audio.shape[0] / sr
        name = os.path.basename(path)
        lyrics = _load_sidecar(path, (".lyrics", ".lrc"))
        s = AudioSample(audio_path=path, filename=name, duration_s=duration,
                        caption=_load_sidecar(path, (".txt", ".caption")), lyrics=lyrics,
                        is_instrumental=not bool(lyrics))
        row = csv_meta.get(name, {})
        if row.get("caption"):
            s.caption = row["caption"]
        if row.get("lyrics"):
            s.lyrics = row["lyrics"]
            s.is_instrumental = False
        if row.get("bpm"):
            try:
                s.bpm = int(float(row["bpm"]))
            except ValueError:
                pass
        for k in ("keyscale", "timesignature", "language", "genres"):
            if row.get(k):
                setattr(s, k, row[k])
        samples.append(s)
    return samples


@torch.no_grad()
def audio_to_codes(engine, codec_params: Dict[str, Any], audio: np.ndarray) -> str:
    """Waveform [L, C] -> the 5 Hz audio-code string: the whole latent frames
    VAE-encoded in 128-frame windows of 32 overlap on the engine's device, then
    the codec's ``tokenize``."""
    hop = engine.vae_cfg.hop_length
    t_frames = max(1, audio.shape[0] // hop)
    x = torch.from_numpy(np.ascontiguousarray(audio[None, :t_frames * hop], np.float32))
    lat = vae.tiled_encode(engine.vae_params, engine.vae_cfg, x.to(engine.device),
                           chunk_frames=128, overlap_frames=32)
    idx = codec.tokenize(codec_params, lat)
    return indices_to_codes(idx[0].cpu().tolist())


def label_sample(sample: AudioSample, engine, lm, codec_params, *, skip_metas: bool = False,
                 format_lyrics: bool = False) -> AudioSample:
    """Stage 2: caption one sample with the LM's understanding flow; fields
    already present (sidecars, csv) win over the LM's."""
    if sample.labeled:
        return sample
    audio, _sr = read_audio(sample.audio_path)
    understood = lm.understand_audio_from_codes(audio_to_codes(engine, codec_params, audio))
    if not skip_metas:
        if sample.bpm is None and isinstance(understood.get("bpm"), int):
            sample.bpm = understood["bpm"]
        for k in ("keyscale", "timesignature", "language", "genres"):
            if not getattr(sample, k) and understood.get(k):
                setattr(sample, k, str(understood[k]))
    if not sample.caption and understood.get("caption"):
        sample.caption = str(understood["caption"])
    if format_lyrics and sample.lyrics:
        formatted = lm.format_sample_from_input(sample.lyrics)
        if formatted.get("caption") and not sample.caption:
            sample.caption = str(formatted["caption"])
    sample.labeled = True
    return sample


def label_all(samples: List[AudioSample], engine, lm, codec_params, progress_callback=None,
              **kw) -> List[AudioSample]:
    """:func:`label_sample` over ``samples``; a sample that fails stays
    unlabeled and is reported through ``progress_callback``."""
    out = []
    for i, s in enumerate(samples):
        if progress_callback:
            progress_callback(f"labeling {i + 1}/{len(samples)}: {s.filename}")
        try:
            out.append(label_sample(s, engine, lm, codec_params, **kw))
        except Exception as e:  # noqa: BLE001 - an unreadable sample is skipped
            if progress_callback:
                progress_callback(f"failed {s.filename}: {e}")
            out.append(s)
    return out
