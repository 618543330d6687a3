"""Port parity: the saved-checkpoint files (acestep_tpu_torch.loader and
serving.launch.build_engine) against the JAX package's loader, on the CPU.

A tree with every quant format plus bf16 and f32 leaves and a list is written
by one package and read by the other, both ways, with every field equal; and
a checkpoint directory the JAX package writes (``save_params`` files plus
``<name>.config.json``) is served through the port's ``build_engine`` with
the same int16 output as an engine built from the same parameters in memory.
Tolerance: exact.
"""

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp
import torch

from acestep_tpu import loader as jloader
from acestep_tpu.quant import quantize_np
from acestep_tpu_torch import loader as tloader
from acestep_tpu_torch import weights
from acestep_tpu_torch.pipeline import GenerationRequest
from acestep_tpu_torch.quant import FIELDS, QuantTensor, stack_layers
from acestep_tpu_torch.serving import launch
from tests.test_torch_pipeline_q4 import (
    Q4_DIT,
    Q4_TEXT,
    SLICE_VAE,
    jax_q4_params,
    port_cfg,
    port_engine,
    request,
)


def _jax_tree():
    rng = np.random.default_rng(0)

    def w(k, n):
        return rng.standard_normal((k, n)).astype(np.float32) * 0.05

    return {
        "blocks": [{"q8": quantize_np(w(256, 16), "q8_0"),
                    "q40": quantize_np(w(256, 16), "q4_0")},
                   {"q4k": quantize_np(w(512, 32), "q4_k"),
                    "q6k": quantize_np(w(256, 48), "q6_k")}],
        "norm": jnp.asarray(rng.standard_normal(16), jnp.bfloat16),
        "conv": {"w": jnp.asarray(rng.standard_normal((3, 4, 5)).astype(np.float32)),
                 "b": jnp.asarray(rng.standard_normal(5).astype(np.float32))},
        "table": jnp.asarray(rng.standard_normal((7, 16)), jnp.bfloat16),
    }


def _assert_same(port, ref):
    """A port tree (torch) against a JAX tree, leaf by leaf and field by field."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(port) == set(ref)
        for k in ref:
            _assert_same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_same(a, b)
    elif hasattr(ref, "fmt"):
        assert isinstance(port, QuantTensor) and port.fmt == ref.fmt
        assert tuple(port.shape) == tuple(ref.shape)
        for f in FIELDS:
            a, b = getattr(port, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if b is not None:
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype, f
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    else:
        b = np.asarray(ref)
        if b.dtype.name == "bfloat16":
            assert port.dtype == torch.bfloat16
            np.testing.assert_array_equal(port.float().numpy(), b.astype(np.float32))
        else:
            assert port.numpy().dtype == b.dtype
            np.testing.assert_array_equal(port.numpy(), b)


def test_jax_files_read_by_the_port(tmp_path):
    tree = _jax_tree()
    jloader.save_params(str(tmp_path / "p"), tree)
    _assert_same(tloader.load_params(str(tmp_path / "p")), tree)


def test_port_files_read_by_jax(tmp_path):
    tree = _jax_tree()
    port = weights.from_jax_numpy(tree)
    # a layer-stacked weight round-trips with its leading axis
    port["stacked"] = stack_layers([port["blocks"][1]["q4k"]] * 2)
    tloader.save_params(str(tmp_path / "p"), port)
    back = jloader.load_params(str(tmp_path / "p"))
    assert back["stacked"].fmt == "q4_k"
    assert np.asarray(back["stacked"].data).shape == (2, 256, 32)
    _assert_same(port, back)
    _assert_same(tloader.load_params(str(tmp_path / "p")), back)


def test_build_engine_serves_a_checkpoint_directory(tmp_path):
    dp, tp, vp = jax_q4_params("q4_k", seed=6)
    ckpt = str(tmp_path)
    for name, params, cfg in (("dit", dp, Q4_DIT), ("vae", vp, SLICE_VAE),
                              ("text_encoder", tp, Q4_TEXT)):
        jloader.save_params(os.path.join(ckpt, name), params)
        with open(os.path.join(ckpt, f"{name}.config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
    eng, dit_tree = launch.build_engine(ckpt, device="cpu")
    assert (eng.dit_cfg, eng.vae_cfg, eng.text_cfg) == \
        (port_cfg(Q4_DIT), port_cfg(SLICE_VAE), port_cfg(Q4_TEXT))
    assert eng.dit_params["layers"]["mlp"]["gateup_proj"]["kernel"].fmt == "q4_k"
    # the checkpoint's own unstacked tree comes back beside the engine
    assert isinstance(dit_tree["layers"], list) and len(dit_tree["layers"]) == Q4_DIT.num_hidden_layers
    assert dit_tree["layers"][0]["mlp"]["gate_proj"]["kernel"].fmt == "q4_k"
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 256, Q4_DIT.audio_acoustic_hidden_dim)).astype(np.float32))
    got = eng.generate(request(GenerationRequest), noise=noise)
    ref = port_engine(dp, tp, vp).generate(request(GenerationRequest), noise=noise)
    np.testing.assert_array_equal(got.audio_i16, ref.audio_i16)
    assert got.audio_scale == ref.audio_scale
