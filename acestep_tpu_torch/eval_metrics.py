"""Audio quality-parity metrics: mae / rmse / cosine / snr_db on the waveform
plus LSD (mean RMS log-spectral distance over STFT frames), and the latent
metrics.  The port's own copy of the JAX package's eval_metrics (numpy only).

These are the quality gates of docs/BENCHMARK.md: the Q8_0 gate holds cosine
>= 0.999 and SNR >= 26 dB on the waveform.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _align(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = min(a.shape[0], b.shape[0])
    return a[:n].astype(np.float64).ravel(), b[:n].astype(np.float64).ravel()


def mae(a: np.ndarray, b: np.ndarray) -> float:
    a, b = _align(a, b)
    return float(np.abs(a - b).mean())


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a, b = _align(a, b)
    return float(np.sqrt(((a - b) ** 2).mean()))


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = _align(a, b)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return 1.0 if np.allclose(a, b) else 0.0
    return float(a @ b / denom)


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against reference signal ``ref``."""
    ref, test = _align(ref, test)
    noise = ref - test
    p_sig = (ref ** 2).mean()
    p_noise = (noise ** 2).mean()
    if p_noise == 0:
        return float("inf")
    return float(10.0 * np.log10(p_sig / max(p_noise, 1e-20)))


def _stft_mag(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Magnitude STFT [frames, n_fft//2+1] with a Hann window (mono input)."""
    window = np.hanning(n_fft)
    n_frames = 1 + max(0, (len(x) - n_fft)) // hop
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop, x.strides[0]),
    )
    return np.abs(np.fft.rfft(frames * window, axis=1))


def lsd(ref: np.ndarray, test: np.ndarray, n_fft: int = 2048, hop: int = 512) -> float:
    """Mean RMS log-spectral distance over STFT frames (log10 power spectra;
    eval_quant_prompt_pipeline.py LSD definition)."""
    ref, test = _align(ref, test)
    if len(ref) < n_fft:
        pad = n_fft - len(ref)
        ref = np.pad(ref, (0, pad))
        test = np.pad(test, (0, pad))
    s_ref = _stft_mag(ref, n_fft, hop)
    s_test = _stft_mag(test, n_fft, hop)
    eps = 1e-10
    log_diff = np.log10((s_ref ** 2) + eps) - np.log10((s_test ** 2) + eps)
    per_frame = np.sqrt((log_diff ** 2).mean(axis=1))
    return float(per_frame.mean())


def waveform_metrics(ref: np.ndarray, test: np.ndarray) -> Dict[str, float]:
    """The full reference metric row: mae/rmse/cosine/snr_db/lsd.

    Inputs may be [L] or [L, C]; channels are flattened for waveform metrics and
    averaged to mono for LSD.
    """
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    ref_mono = ref.mean(axis=-1) if ref.ndim == 2 else ref
    test_mono = test.mean(axis=-1) if test.ndim == 2 else test
    return {
        "mae": mae(ref, test),
        "rmse": rmse(ref, test),
        "cosine": cosine(ref, test),
        "snr_db": snr_db(ref, test),
        "lsd": lsd(ref_mono, test_mono),
    }


def latent_metrics(ref: np.ndarray, test: np.ndarray) -> Dict[str, float]:
    """Parity metrics on latent tensors (compare_dit.py style: mae/max/cosine)."""
    a = np.asarray(ref, dtype=np.float64).ravel()
    b = np.asarray(test, dtype=np.float64).ravel()
    return {
        "mae": float(np.abs(a - b).mean()),
        "max_err": float(np.abs(a - b).max()),
        "cosine": cosine(a, b),
    }
