"""The port's native C++ quantizers (acestep_tpu_torch.native, through
``quant/native_bridge``) against the port's ``formats.quantize`` and the JAX
package's numpy ``quantize_np``: 0 differing elements in every field of every
format, at the K of the full-width DiT's linears (512, 2048, 6144) and at
K = 384, where a 4-bit format falls back to q8_0; plus the build (under
``build/native/`` only, a failed build raises with g++'s output) and the
native bf16 cast.
"""

import os

import numpy as np
import pytest
import torch

from acestep_tpu.quant import quantize_np
from acestep_tpu.utils.safetensors_io import f32_to_bf16_raw
from acestep_tpu_torch import native
from acestep_tpu_torch.quant import QUANT_FORMATS, quantize, supported_format_for
from acestep_tpu_torch.quant.native_bridge import f32_to_bf16_fast, quantize_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("k", [512, 2048, 6144, 384])
@pytest.mark.parametrize("fmt", QUANT_FORMATS)
def test_native_equals_formats_and_numpy(fmt, k):
    rng = np.random.default_rng(k)
    w = (rng.standard_normal((k, 96)) * 0.07).astype(np.float32)
    w[:32, 0] = 0.0                      # an all-zero block: zero scales
    eff = supported_format_for(k, fmt)
    got = quantize_native(w, eff)
    port = quantize(torch.from_numpy(w), eff)
    ref = quantize_np(w, eff)
    assert got.fmt == port.fmt == eff and got.shape == (k, 96)
    assert set(got.fields()) == set(port.fields())
    for f, a in got.fields().items():
        assert a.device.type == "cpu" and a.dtype == getattr(port, f).dtype, f
        assert int((_bits(a) != _bits(getattr(port, f))).sum()) == 0, f"{eff}.{f} vs formats"
        assert int((_bits(a) != _bits(getattr(ref, f))).sum()) == 0, f"{eff}.{f} vs quantize_np"


def test_shapes_the_native_loops_do_not_take():
    """A K off the format's block goes to formats.quantize, which raises as
    quantize_np does."""
    w = np.ones((384, 64), np.float32)
    for fmt in ("q4_0", "q4_k", "q6_k"):
        with pytest.raises(ValueError):
            quantize_native(w, fmt)
        with pytest.raises(ValueError):
            quantize_np(w, fmt)
    with pytest.raises(ValueError):
        quantize_native(np.ones((48, 64), np.float32), "q8_0")


def test_bf16_cast_matches_torch_and_numpy():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(100003) * 10).astype(np.float32)
    got = f32_to_bf16_fast(x)
    np.testing.assert_array_equal(got, f32_to_bf16_raw(x))
    np.testing.assert_array_equal(
        got.view(np.int16), torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy())


def test_build_lands_under_build_native():
    path = native.build()
    assert path.startswith(os.path.join(REPO, "build", "native") + os.sep)
    assert os.path.exists(path)
    assert not [f for f in os.listdir(os.path.dirname(native.SOURCE)) if f.endswith(".so")]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "quant_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
        native.build()
    assert "error" in str(exc.value)
    assert not list((tmp_path / "build").rglob("*.so"))
