"""WAV IO and audio helpers (numpy only, no audio library): port of the JAX
package's utils/audio.py, byte for byte the same files.

16-bit PCM: float input is clipped to [-1, 1], scaled by 32767 and rounded;
reading divides by 32767, so -32768 reads back as -32767 / 32767 and below
-1.  ``AudioSaver`` writes wav, flac (utils/flac.py) or mp3 (utils/mp3.py,
WAV with a warning where libmp3lame is absent), with content-derived
deterministic file names.
"""

from __future__ import annotations

import hashlib
import io
import os
import struct
import uuid
import warnings
from typing import Tuple

import numpy as np


def _pcm_segments(audio) -> list:
    """One [L, C] array, or a list of time-contiguous segments, as a list of
    contiguous little-endian int16 [L, C] arrays.  int16 input passes through
    without a copy (the engine's PCM, possibly segmented)."""
    segs = list(audio) if isinstance(audio, (list, tuple)) else [audio]
    out = []
    for a in segs:
        a = np.asarray(a)
        if a.ndim == 1:
            a = a[:, None]
        if a.dtype == np.int16:
            out.append(np.ascontiguousarray(a))
        else:
            a = np.clip(a.astype(np.float64), -1.0, 1.0)
            out.append(np.ascontiguousarray(np.round(a * 32767.0).astype("<i2")))
    return out


def _wav_header(n_bytes: int, n_channels: int, sample_rate: int) -> bytes:
    byte_rate = sample_rate * n_channels * 2
    return (
        b"RIFF" + struct.pack("<I", 36 + n_bytes) + b"WAVEfmt "
        + struct.pack("<IHHIIHH", 16, 1, n_channels, sample_rate,
                      byte_rate, n_channels * 2, 16)
        + b"data" + struct.pack("<I", n_bytes)
    )


def write_wav(path: str, audio, sample_rate: int = 48000) -> None:
    """Write audio ([L, C], or a list of time-contiguous segments) as 16-bit
    PCM; segments stream to the file without being joined first."""
    segs = _pcm_segments(audio)
    n_bytes = sum(s.nbytes for s in segs)
    # unbuffered: the PCM memory is written as it is, not copied in chunks
    with open(path, "wb", buffering=0) as f:
        f.write(_wav_header(n_bytes, segs[0].shape[1], sample_rate))
        for s in segs:
            f.write(memoryview(s).cast("B"))   # interleaved (samples-major)


def wav_bytes(audio, sample_rate: int = 48000) -> bytes:
    """16-bit WAV as bytes (as :func:`write_wav`; a segment list too)."""
    segs = _pcm_segments(audio)
    n_bytes = sum(s.nbytes for s in segs)
    parts = [_wav_header(n_bytes, segs[0].shape[1], sample_rate)]
    parts.extend(s.tobytes() for s in segs)
    return b"".join(parts)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A 16-bit or float32 PCM WAV -> ([L, C] float32, sample_rate)."""
    with open(path, "rb") as f:
        return _read_wav_stream(f, path)


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """:func:`read_wav` of bytes (an uploaded payload)."""
    return _read_wav_stream(io.BytesIO(data), "<bytes>")


def _read_wav_stream(f, path: str) -> Tuple[np.ndarray, int]:
    riff = f.read(12)
    if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    fmt = None
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        chunk = f.read(size + (size & 1))[:size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", chunk[:16])
        elif cid == b"data":
            data = chunk
    if fmt is None or data is None:
        raise ValueError(f"malformed WAV: {path}")
    audio_format, n_channels, sample_rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32767.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format {audio_format}/{bits}bit")
    return x.reshape(-1, n_channels), sample_rate


def peak_normalize(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    """Scale so max |x| == peak, only where it exceeds ``peak``."""
    m = np.abs(audio).max()
    if m > peak and m > 0:
        return audio * (peak / m)
    return audio


def content_hash(audio: np.ndarray, sample_rate: int) -> str:
    """SHA-256 of the sample rate and the 16-bit PCM payload."""
    pcm = np.round(np.clip(np.asarray(audio, np.float64), -1.0, 1.0) * 32767.0)
    h = hashlib.sha256()
    h.update(str(int(sample_rate)).encode())
    h.update(pcm.astype("<i2").tobytes())
    return h.hexdigest()


def deterministic_uuid(audio: np.ndarray, sample_rate: int, *extra: str) -> str:
    """UUID5 of the audio content and optional request fields: identical
    generations get identical ids."""
    name = content_hash(audio, sample_rate) + "|" + "|".join(extra)
    return str(uuid.uuid5(uuid.NAMESPACE_URL, name))


class AudioSaver:
    """Save audio as wav, flac or mp3.  mp3 needs the system libmp3lame
    (utils/mp3.py); without it the saver warns and writes WAV."""

    FORMATS = ("wav", "flac", "mp3")

    def __init__(self, default_format: str = "wav"):
        self.default_format = default_format

    def save(self, audio: np.ndarray, path: str, sample_rate: int = 48000,
             audio_format: str = None) -> str:
        """Write audio; returns the path written (the extension follows the
        format actually written)."""
        fmt = (audio_format or self.default_format).lower().lstrip(".")
        root, _ = os.path.splitext(path)
        if fmt == "flac":
            from acestep_tpu_torch.utils import flac

            if isinstance(audio, (list, tuple)):   # segmented decode output
                audio = np.concatenate([np.asarray(a) for a in audio], axis=0)
            out = root + ".flac"
            flac.write_flac(out, audio, sample_rate)
            return out
        if fmt == "mp3":
            from acestep_tpu_torch.utils import mp3

            if mp3.encoder_available():
                if isinstance(audio, (list, tuple)):
                    audio = np.concatenate([np.asarray(a) for a in audio], axis=0)
                out = root + ".mp3"
                mp3.write_mp3(out, np.asarray(audio), sample_rate)
                return out
            warnings.warn("libmp3lame not available on this host; saving WAV instead",
                          stacklevel=2)
        out = root + ".wav"
        write_wav(out, audio, sample_rate)
        return out

    def save_batch(self, audios, sample_rate: int = 48000, out_dir: str = ".",
                   audio_format: str = None, prefix: str = "", request_key: str = ""):
        """Save a batch under content-derived names; returns the paths."""
        paths = []
        for item in audios:
            uid = deterministic_uuid(item, sample_rate, request_key)
            path = os.path.join(out_dir, f"{prefix}{uid}.wav")
            paths.append(self.save(item, path, sample_rate, audio_format))
        return paths
