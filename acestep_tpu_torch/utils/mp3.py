"""MP3 encode and decode through ctypes bindings to the system libmp3lame and
libmpg123: port of the JAX package's utils/mp3.py.

No Python package is needed, only the shared libraries (``libmp3lame.so.0``,
``libmpg123.so.0``) where the host has them.  ``encoder_available()`` and
``decoder_available()`` say which loaded; without LAME, ``AudioSaver`` and
the server write WAV instead.

Encode: float (or int16) PCM -> CBR mp3 at ``bitrate_kbps`` (default 320),
joint stereo, LAME quality 2.  Decode: any MPEG audio stream mpg123 reads ->
float32 [N, C] and its rate (mp3 uploads, round trips).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional, Tuple

import numpy as np

_LAME_CANDIDATES = ("mp3lame", "libmp3lame.so.0", "libmp3lame.so",
                    "libmp3lame.dylib")
_MPG123_CANDIDATES = ("mpg123", "libmpg123.so.0", "libmpg123.so",
                      "libmpg123.dylib")


def _load(candidates) -> Optional[ctypes.CDLL]:
    for name in candidates:
        try:
            found = ctypes.util.find_library(name) if "." not in name else name
            if found:
                return ctypes.CDLL(found)
        except OSError:
            continue
    return None


_lame = _load(_LAME_CANDIDATES)
_mpg123 = _load(_MPG123_CANDIDATES)

if _lame is not None:
    _lame.lame_init.restype = ctypes.c_void_p
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_brate", "lame_set_quality", "lame_set_mode",
               "lame_init_params", "lame_close"):
        getattr(_lame, fn).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if fn.startswith("lame_set") else [])
        getattr(_lame, fn).restype = ctypes.c_int
    _lame.lame_encode_buffer_interleaved_ieee_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    _lame.lame_encode_buffer_interleaved_ieee_float.restype = ctypes.c_int
    _lame.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
    _lame.lame_encode_flush.restype = ctypes.c_int

if _mpg123 is not None:
    _mpg123.mpg123_init.restype = ctypes.c_int
    _mpg123.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
    _mpg123.mpg123_new.restype = ctypes.c_void_p
    _mpg123.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    _mpg123.mpg123_open.restype = ctypes.c_int
    _mpg123.mpg123_format_none.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
    _mpg123.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _mpg123.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    _mpg123.mpg123_read.restype = ctypes.c_int
    _mpg123.mpg123_close.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_delete.argtypes = [ctypes.c_void_p]
    _mpg123.mpg123_init()                  # no-op on modern mpg123, required
    # on old ones; safe either way

_MPG123_OK, _MPG123_DONE, _MPG123_NEW_FORMAT = 0, -12, -11
_MPG123_ENC_FLOAT_32 = 0x200


def encoder_available() -> bool:
    return _lame is not None


def decoder_available() -> bool:
    return _mpg123 is not None


def encode_mp3(audio: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 320) -> bytes:
    """float PCM [N] / [N, C] in [-1, 1] -> CBR mp3 bytes (joint stereo)."""
    if _lame is None:
        raise RuntimeError("libmp3lame not available on this host")
    a = np.asarray(audio)
    if a.dtype == np.int16:                # device PCM passes straight through
        a = a.astype(np.float32) / 32768.0
    else:
        a = a.astype(np.float32)
    if a.ndim == 1:
        a = a[:, None]
    if a.shape[1] == 1:
        a = np.repeat(a, 2, axis=1)        # LAME interleaved API is stereo
    elif a.shape[1] != 2:
        raise ValueError(f"expected mono/stereo, got {a.shape[1]} channels")
    n = a.shape[0]

    gfp = _lame.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        _lame.lame_set_in_samplerate(gfp, int(sample_rate))
        _lame.lame_set_num_channels(gfp, 2)
        _lame.lame_set_brate(gfp, int(bitrate_kbps))
        _lame.lame_set_mode(gfp, 1)        # joint stereo
        _lame.lame_set_quality(gfp, 2)     # high-quality psychoacoustics
        if _lame.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params rejected sr={sample_rate} "
                f"brate={bitrate_kbps}")
        out = bytearray()
        CHUNK = 1152 * 64                  # frames per call
        # LAME worst case: 1.25*nsamples + 7200 bytes per call
        buf = (ctypes.c_ubyte * (CHUNK * 5 // 4 + 7200))()
        inter = np.ascontiguousarray(a.reshape(-1))
        for s0 in range(0, n, CHUNK):
            piece = inter[s0 * 2:(s0 + min(CHUNK, n - s0)) * 2]
            nn = piece.shape[0] // 2
            rc = _lame.lame_encode_buffer_interleaved_ieee_float(
                gfp, piece.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                nn, buf, len(buf))
            if rc < 0:
                raise RuntimeError(f"lame_encode_buffer failed: {rc}")
            out += bytes(buf[:rc])
        rc = _lame.lame_encode_flush(gfp, buf, len(buf))
        if rc > 0:
            out += bytes(buf[:rc])
        return bytes(out)
    finally:
        _lame.lame_close(gfp)


def write_mp3(path: str, audio: np.ndarray, sample_rate: int,
              bitrate_kbps: int = 320) -> None:
    data = encode_mp3(audio, sample_rate, bitrate_kbps)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """mp3 file -> (float32 audio [N, C], sample_rate) via mpg123."""
    if _mpg123 is None:
        raise RuntimeError("libmpg123 not available on this host")
    err = ctypes.c_int(0)
    h = _mpg123.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        # force float32 output at the stream's native rate/channels
        _mpg123.mpg123_format_none(h)
        for rate in (8000, 11025, 12000, 16000, 22050, 24000, 32000,
                     44100, 48000):
            _mpg123.mpg123_format(h, rate, 3, _MPG123_ENC_FLOAT_32)
        if _mpg123.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path!r}")
        try:
            rate = ctypes.c_long(0)
            chans = ctypes.c_int(0)
            enc = ctypes.c_int(0)
            _mpg123.mpg123_getformat(h, ctypes.byref(rate),
                                     ctypes.byref(chans), ctypes.byref(enc))
            chunks = []
            buf = (ctypes.c_ubyte * (1 << 18))()
            done = ctypes.c_size_t(0)
            while True:
                rc = _mpg123.mpg123_read(h, buf, len(buf),
                                         ctypes.byref(done))
                if done.value:
                    chunks.append(bytes(buf[: done.value]))
                if rc == _MPG123_DONE:
                    break
                if rc == _MPG123_NEW_FORMAT:
                    _mpg123.mpg123_getformat(
                        h, ctypes.byref(rate), ctypes.byref(chans),
                        ctypes.byref(enc))
                    continue
                if rc != _MPG123_OK:
                    raise RuntimeError(f"mpg123_read failed: {rc}")
            pcm = np.frombuffer(b"".join(chunks), np.float32)
            c = max(1, chans.value)
            return pcm.reshape(-1, c), int(rate.value)
        finally:
            _mpg123.mpg123_close(h)
    finally:
        _mpg123.mpg123_delete(h)


def decode_mp3_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """mp3 bytes -> (audio, rate); file-based under the hood (the feed API's
    buffering adds nothing here and the tmp file stays on tmpfs)."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        return decode_mp3(tmp)
    finally:
        os.unlink(tmp)
