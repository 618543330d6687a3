"""Port parity of the audio writers and readers (acestep_tpu_torch.utils:
audio, flac, mp3) against the JAX package's, on the CPU.

Both packages are numpy (and ctypes for mp3), so the bytes must be equal: WAV
and FLAC for the same PCM, and each package reads the other's bytes to the
same arrays.  MP3 is held the same way where both libmp3lame and libmpg123
load (LAME is deterministic for the same input and settings).
"""

import warnings

import numpy as np
import pytest

from acestep_tpu.utils import audio as jaudio
from acestep_tpu.utils import flac as jflac
from acestep_tpu.utils import mp3 as jmp3
from acestep_tpu_torch.utils import audio as taudio
from acestep_tpu_torch.utils import flac as tflac
from acestep_tpu_torch.utils import mp3 as tmp3

SR = 48000


def _clips():
    """Float and int16 clips that reach every branch: clipping past +-1,
    -32768, silence (CONSTANT subframes), smooth sines (FIXED), noise
    (VERBATIM), mono, and more than one 4096-sample FLAC block."""
    rng = np.random.default_rng(0)
    n = 9000
    t = np.arange(n) / SR
    sine = 0.6 * np.sin(2 * np.pi * 440.0 * t)
    stereo = np.stack([sine, 0.3 * np.sin(2 * np.pi * 660.0 * t + 1.0)], 1)
    stereo[:50] = [1.5, -1.7]                              # clipped
    stereo[4096:4300] = 0.0                                # a silent stretch
    noise = rng.uniform(-1, 1, (5000, 2))
    i16 = rng.integers(-32768, 32768, (6000, 2)).astype(np.int16)
    i16[0] = -32768
    return {"stereo f32": stereo.astype(np.float32), "mono f64": sine,
            "noise": noise.astype(np.float32), "int16": i16,
            "silence": np.zeros((8192, 2), np.float32)}


CLIPS = _clips()


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_wav_bytes_equal_and_read_across(name):
    a = CLIPS[name]
    ref, got = jaudio.wav_bytes(a, SR), taudio.wav_bytes(a, SR)
    assert got == ref
    for read in (jaudio.read_wav_bytes, taudio.read_wav_bytes):
        x_ref, sr_ref = jaudio.read_wav_bytes(ref)
        x, sr = read(got)
        assert sr == sr_ref == SR
        np.testing.assert_array_equal(x, x_ref)
    # float goes in scaled by 32767 and comes out divided by it
    x, _ = taudio.read_wav_bytes(got)
    if a.dtype == np.int16:
        np.testing.assert_array_equal(x, a.astype(np.float32) / 32767.0)
        assert x.min() < -1.0                               # -32768 / 32767


def test_wav_segments_and_files(tmp_path):
    a = CLIPS["stereo f32"]
    segs = [np.round(np.clip(a[:4000], -1, 1) * 32767).astype(np.int16),
            np.round(np.clip(a[4000:], -1, 1) * 32767).astype(np.int16)]
    assert taudio.wav_bytes(segs, SR) == jaudio.wav_bytes(segs, SR) == taudio.wav_bytes(a, SR)
    jaudio.write_wav(str(tmp_path / "j.wav"), segs, SR)
    taudio.write_wav(str(tmp_path / "t.wav"), segs, SR)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "t.wav").read_bytes()
    x, sr = taudio.read_wav(str(tmp_path / "j.wav"))
    np.testing.assert_array_equal(x, jaudio.read_wav(str(tmp_path / "t.wav"))[0])
    np.testing.assert_array_equal(taudio.peak_normalize(a * 3), jaudio.peak_normalize(a * 3))
    assert taudio.deterministic_uuid(a, SR, "k") == jaudio.deterministic_uuid(a, SR, "k")


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_flac_bytes_equal_and_decode_across(name, compress):
    a = CLIPS[name]
    ref, got = jflac.encode_flac(a, SR, compress), tflac.encode_flac(a, SR, compress)
    assert got[:4] == b"fLaC" and got == ref
    x_ref, sr_ref = jflac.decode_flac(got)
    x, sr = tflac.decode_flac(ref)
    assert sr == sr_ref == SR
    np.testing.assert_array_equal(x, x_ref)
    # lossless against the WAV path's PCM
    np.testing.assert_array_equal(x, taudio.read_wav_bytes(taudio.wav_bytes(a, SR))[0])


def test_audio_saver_writes_the_same_files(tmp_path):
    """wav, flac and mp3 (WAV with a warning in both packages where
    libmp3lame is absent): the same file name extension and bytes."""
    a = CLIPS["stereo f32"]
    for fmt in ("wav", "flac", "mp3"):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            p_ref = jaudio.AudioSaver(fmt).save(a, str(tmp_path / f"j_{fmt}.x"), SR)
            p_got = taudio.AudioSaver(fmt).save(a, str(tmp_path / f"t_{fmt}.x"), SR)
        assert len(seen) in (0, 2)
        assert p_got.rsplit(".", 1)[1] == p_ref.rsplit(".", 1)[1]
        assert open(p_got, "rb").read() == open(p_ref, "rb").read()


MP3 = tmp3.encoder_available() and tmp3.decoder_available() and \
    jmp3.encoder_available() and jmp3.decoder_available()


@pytest.mark.skipif(not MP3, reason="libmp3lame or libmpg123 is not on this host")
@pytest.mark.parametrize("name", ["stereo f32", "int16", "mono f64"])
def test_mp3_bytes_equal_and_decode_across(name):
    a = CLIPS[name]
    ref, got = jmp3.encode_mp3(a, SR), tmp3.encode_mp3(a, SR)
    assert got[0] == 0xFF and (got[1] & 0xE0) == 0xE0 and got == ref
    x_ref, sr_ref = jmp3.decode_mp3_bytes(got)
    x, sr = tmp3.decode_mp3_bytes(ref)
    assert sr == sr_ref == SR and x.shape[1] == 2
    np.testing.assert_array_equal(x, x_ref)
