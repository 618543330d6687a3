"""Checkpoints: the reference's safetensors into the port's parameter trees
(quantized once, ahead of time), and those trees to and from disk.

**The reference importers** (:func:`load_qwen`, :func:`load_dit`,
:func:`load_vae`) are the port's copy of the JAX package's ``loader.py``: the
same names, the same tree, the same dtypes and the same transforms, so a
checkpoint converted by either package is the same bytes.  Names come from the
reference loaders: the DiT's ``decoder.*`` / ``encoder.*`` tensors, the Oobleck
VAE's weight-norm pairs (``weight_v`` / ``weight_g``, folded as
``w = v * g / ||v||`` over dims 1-2 of each dim-0 slice, in f64 on the host) and
the HF Qwen3 names.  Layout transforms (torch -> the kernels' layout):

  Linear   [out, in]        -> [in, out]            (transpose)
  Conv1d   [out, in, k]     -> [k, in, out]         (transpose(2, 1, 0))
  ConvT1d  [in, out, k]     -> [k, in, out] reversed (transpose(2, 0, 1)[::-1])
  patchify Conv1d stride=p  -> linear [p*C, H]      (transpose(2, 1, 0).reshape)
  unpatch  ConvT1d stride=p -> linear [H, p*A]      (transpose(0, 2, 1).reshape)

Every transform runs on the host in numpy, one tensor at a time.  The kernels
that ``quant.convert.importer_policy`` picks are quantized to
``supported_format_for(K, quant)`` on the host by the native C++ quantizers
(``quant/native_bridge``).  The trees come back on the CPU.

**The port's format** (:func:`save_params` / :func:`load_params`):
``<path>.safetensors`` plus a ``<path>.json`` manifest, the files the JAX
package's ``loader.save_params`` / ``load_params`` write and read.
Leaves are flattened to ``/``-joined names (list items by index).  A quantized
weight stores each field as ``<name>#<field>`` and its manifest entry
``{"type": "quant", "fmt", "shape", "fields", ["bf16_fields"]}``; a bf16 leaf is
stored as raw bf16 bits (``{"type": "bf16"}``), any other leaf as it is
(``{"type": "array"}``).  Loading rebuilds the nesting and turns dicts whose
keys are all digits back into lists.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.quant.convert import importer_policy, leaf_format
from acestep_tpu_torch.quant.native_bridge import quantize_native
from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile, save_safetensors
from acestep_tpu_torch.weights import flatten

TensorGetter = Callable[[str], np.ndarray]


def _getter(src) -> TensorGetter:
    if isinstance(src, SafetensorsFile):
        return lambda name: src.tensor(name, as_f32=True)
    if isinstance(src, dict):
        return lambda name: np.asarray(src[name], dtype=np.float32)
    raise TypeError(f"unsupported tensor source: {type(src)}")


def _has(src, name: str) -> bool:
    if isinstance(src, SafetensorsFile):
        return name in src.header
    return name in src


def _tensor(w: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32)).to(dtype)


def _kernel(path: str, w: np.ndarray, fmt: Optional[str], dtype):
    """``w`` in kernel layout [K, N] at tree ``path``: quantized on the host by
    the native quantizers where ``quant.convert.leaf_format`` gives it a
    format under ``importer_policy``, else cast to ``dtype``."""
    eff = leaf_format(path, w, fmt, importer_policy)
    return _tensor(w, dtype) if eff is None else quantize_native(w, eff)


def _linear(get, at: str, name: str, fmt, dtype, bias_name: Optional[str] = None, src=None):
    out = {"kernel": _kernel(at + "/kernel", get(name).T.copy(), fmt, dtype)}
    if bias_name and src is not None and _has(src, bias_name):
        out["bias"] = _tensor(get(bias_name), dtype)
    return out


# ---------------------------------------------------------------------------
# Qwen3 (text encoder / LM)
# ---------------------------------------------------------------------------

def load_qwen(src, cfg: QwenConfig, quant: Optional[str] = None, dtype=torch.bfloat16,
              prefix: str = "") -> Dict[str, Any]:
    """A Qwen3 tree from HF names (``model.``-prefixed or bare); ``lm_head``
    only where the checkpoint has one and the embeddings are not tied."""
    get = _getter(src)

    def pick(*names):
        for n in names:
            if _has(src, prefix + n):
                return prefix + n
        raise KeyError(f"none of {names} found (prefix={prefix!r})")

    emb_name = pick("model.embed_tokens.weight", "embed_tokens.weight")
    base = emb_name.rsplit("embed_tokens.weight", 1)[0]

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"{base}layers.{i}."

        def lin(key, n):
            return _linear(get, f"/layers/{i}/{key}", p + n, quant, dtype)

        layers.append({
            "input_norm": _tensor(get(p + "input_layernorm.weight"), dtype),
            "q_proj": lin("q_proj", "self_attn.q_proj.weight"),
            "k_proj": lin("k_proj", "self_attn.k_proj.weight"),
            "v_proj": lin("v_proj", "self_attn.v_proj.weight"),
            "o_proj": lin("o_proj", "self_attn.o_proj.weight"),
            "q_norm": _tensor(get(p + "self_attn.q_norm.weight"), dtype),
            "k_norm": _tensor(get(p + "self_attn.k_norm.weight"), dtype),
            "post_norm": _tensor(get(p + "post_attention_layernorm.weight"), dtype),
            "gate_proj": lin("gate_proj", "mlp.gate_proj.weight"),
            "up_proj": lin("up_proj", "mlp.up_proj.weight"),
            "down_proj": lin("down_proj", "mlp.down_proj.weight"),
        })

    params = {
        "embed_tokens": _tensor(get(emb_name), dtype),
        "layers": layers,
        "norm": _tensor(get(base + "norm.weight"), dtype),
    }
    lm_head = prefix + "lm_head.weight"
    if _has(src, lm_head) and not cfg.tie_word_embeddings:
        params["lm_head"] = _linear(get, "/lm_head", lm_head, quant, dtype)
    return params


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

def _attn(get, at: str, p: str, fmt, dtype):
    def lin(n):
        return _linear(get, f"{at}/{n}", p + n + ".weight", fmt, dtype)
    return {
        "q_proj": lin("q_proj"),
        "k_proj": lin("k_proj"),
        "v_proj": lin("v_proj"),
        "o_proj": lin("o_proj"),
        "q_norm": _tensor(get(p + "q_norm.weight"), dtype),
        "k_norm": _tensor(get(p + "k_norm.weight"), dtype),
    }


def _mlp(get, at: str, p: str, fmt, dtype):
    def lin(n):
        return _linear(get, f"{at}/{n}", p + n + ".weight", fmt, dtype)
    return {
        "gate_proj": lin("gate_proj"),
        "up_proj": lin("up_proj"),
        "down_proj": lin("down_proj"),
    }


def _encoder_layer(get, at: str, p: str, fmt, dtype):
    return {
        "input_norm": _tensor(get(p + "input_layernorm.weight"), dtype),
        "self_attn": _attn(get, at + "/self_attn", p + "self_attn.", fmt, dtype),
        "post_norm": _tensor(get(p + "post_attention_layernorm.weight"), dtype),
        "mlp": _mlp(get, at + "/mlp", p + "mlp.", fmt, dtype),
    }


def _timestep_embed(get, at: str, p: str, fmt, dtype, src):
    return {n: _linear(get, f"{at}/{n}", f"{p}{n}.weight", fmt, dtype, f"{p}{n}.bias", src)
            for n in ("linear_1", "linear_2", "time_proj")}


def load_dit(src, cfg: DiTConfig, quant: Optional[str] = None,
             dtype=torch.bfloat16) -> Dict[str, Any]:
    """The DiT tree (per-layer lists) from the reference's ``decoder.*`` /
    ``encoder.*`` names; the lyric and timbre encoders where present.  The
    timestep embeddings and the timbre ``embed_tokens`` stay unquantized
    (``importer_policy``)."""
    get, fmt = _getter(src), quant

    # patchify conv1d [H, C, p] -> [p*C, H]
    w_in = get("decoder.proj_in.1.weight")
    proj_in = {
        "kernel": _kernel("/proj_in/kernel",
                          w_in.transpose(2, 1, 0).reshape(-1, w_in.shape[0]).copy(), fmt, dtype),
        "bias": _tensor(get("decoder.proj_in.1.bias"), dtype),
    }
    # unpatchify convtranspose1d [H, A, p] -> [H, p*A]
    w_out = get("decoder.proj_out.1.weight")
    proj_out = {
        "kernel": _kernel("/proj_out/kernel",
                          w_out.transpose(0, 2, 1).reshape(w_out.shape[0], -1).copy(), fmt,
                          dtype),
        "bias": _tensor(get("decoder.proj_out.1.bias"), dtype),
    }

    layers = []
    for i in range(cfg.num_hidden_layers):
        p, at = f"decoder.layers.{i}.", f"/layers/{i}"
        layers.append({
            "self_attn_norm": _tensor(get(p + "self_attn_norm.weight"), dtype),
            "self_attn": _attn(get, at + "/self_attn", p + "self_attn.", fmt, dtype),
            "cross_attn_norm": _tensor(get(p + "cross_attn_norm.weight"), dtype),
            "cross_attn": _attn(get, at + "/cross_attn", p + "cross_attn.", fmt, dtype),
            "mlp_norm": _tensor(get(p + "mlp_norm.weight"), dtype),
            "mlp": _mlp(get, at + "/mlp", p + "mlp.", fmt, dtype),
            "scale_shift_table": _tensor(get(p + "scale_shift_table").reshape(6, -1), dtype),
        })

    params = {
        "proj_in": proj_in,
        "time_embed": _timestep_embed(get, "/time_embed", "decoder.time_embed.", fmt, dtype,
                                      src),
        "time_embed_r": _timestep_embed(get, "/time_embed_r", "decoder.time_embed_r.", fmt,
                                        dtype, src),
        "condition_embedder": _linear(get, "/condition_embedder",
                                      "decoder.condition_embedder.weight", fmt, dtype,
                                      "decoder.condition_embedder.bias", src),
        "layers": layers,
        "norm_out": _tensor(get("decoder.norm_out.weight"), dtype),
        "out_scale_shift_table": _tensor(get("decoder.scale_shift_table").reshape(2, -1),
                                         dtype),
        "proj_out": proj_out,
    }

    if _has(src, "encoder.text_projector.weight"):
        params["text_projector"] = _linear(get, "/text_projector",
                                           "encoder.text_projector.weight", fmt, dtype)
    for enc, n_layers in (("lyric", cfg.num_lyric_encoder_hidden_layers),
                          ("timbre", cfg.num_timbre_encoder_hidden_layers)):
        p = f"encoder.{enc}_encoder."
        if not _has(src, p + "embed_tokens.weight"):
            continue
        params[f"{enc}_embed"] = _linear(get, f"/{enc}_embed", p + "embed_tokens.weight", fmt,
                                         dtype, p + "embed_tokens.bias", src)
        params[f"{enc}_layers"] = [
            _encoder_layer(get, f"/{enc}_layers/{i}", f"{p}layers.{i}.", fmt, dtype)
            for i in range(n_layers)]
        params[f"{enc}_norm"] = _tensor(get(p + "norm.weight"), dtype)
        if enc == "timbre" and _has(src, p + "special_token"):
            params["timbre_special_token"] = _tensor(get(p + "special_token").reshape(-1),
                                                     dtype)
    return params


# ---------------------------------------------------------------------------
# VAE (diffusers AutoencoderOobleck, weight norm folded)
# ---------------------------------------------------------------------------

def _fold_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``w = v * g / ||v||`` with the norm over dims (1, 2) of each dim-0 slice
    (torch.nn.utils.weight_norm, dim=0), in f64 on the host, rounded once to
    f32: the JAX importer's bytes."""
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True) + 1e-12)
    return (v * (g.reshape(-1, 1, 1) / norm)).astype(np.float32)


def _vae_conv(get, src, prefix: str, transposed: bool, dtype, with_bias=True):
    if _has(src, prefix + ".weight_v"):
        w = _fold_weight_norm(get(prefix + ".weight_v"), get(prefix + ".weight_g"))
    else:
        w = get(prefix + ".weight")
    if transposed:  # torch [in, out, k] -> reversed [k, in, out]
        w = w.transpose(2, 0, 1)[::-1].copy()
    else:           # torch [out, in, k] -> [k, in, out]
        w = w.transpose(2, 1, 0).copy()
    out = {"w": _tensor(w, dtype)}
    if with_bias and _has(src, prefix + ".bias"):
        out["b"] = _tensor(get(prefix + ".bias"), dtype)
    return out


def _vae_snake(get, prefix: str, dtype):
    return {
        "alpha": _tensor(get(prefix + ".alpha").reshape(-1), dtype),
        "beta": _tensor(get(prefix + ".beta").reshape(-1), dtype),
    }


def _res_unit(get, src, prefix: str, dtype):
    return {
        "snake1": _vae_snake(get, prefix + ".snake1", dtype),
        "conv1": _vae_conv(get, src, prefix + ".conv1", False, dtype),
        "snake2": _vae_snake(get, prefix + ".snake2", dtype),
        "conv2": _vae_conv(get, src, prefix + ".conv2", False, dtype),
    }


def load_vae(src, cfg: VAEConfig, dtype=torch.float32) -> Dict[str, Any]:
    """The Oobleck VAE tree (encoder and decoder), weight norm folded."""
    get = _getter(src)

    enc_blocks = []
    for i in range(len(cfg.downsampling_ratios)):
        p = f"encoder.block.{i}"
        enc_blocks.append({
            "res1": _res_unit(get, src, p + ".res_unit1", dtype),
            "res2": _res_unit(get, src, p + ".res_unit2", dtype),
            "res3": _res_unit(get, src, p + ".res_unit3", dtype),
            "snake1": _vae_snake(get, p + ".snake1", dtype),
            "conv1": _vae_conv(get, src, p + ".conv1", False, dtype),
        })
    dec_blocks = []
    for i in range(len(cfg.upsampling_ratios)):
        p = f"decoder.block.{i}"
        dec_blocks.append({
            "snake1": _vae_snake(get, p + ".snake1", dtype),
            "conv_t1": _vae_conv(get, src, p + ".conv_t1", True, dtype),
            "res1": _res_unit(get, src, p + ".res_unit1", dtype),
            "res2": _res_unit(get, src, p + ".res_unit2", dtype),
            "res3": _res_unit(get, src, p + ".res_unit3", dtype),
        })
    return {
        "encoder": {
            "conv1": _vae_conv(get, src, "encoder.conv1", False, dtype),
            "blocks": enc_blocks,
            "snake1": _vae_snake(get, "encoder.snake1", dtype),
            "conv2": _vae_conv(get, src, "encoder.conv2", False, dtype),
        },
        "decoder": {
            "conv1": _vae_conv(get, src, "decoder.conv1", False, dtype),
            "blocks": dec_blocks,
            "snake1": _vae_snake(get, "decoder.snake1", dtype),
            "conv2": _vae_conv(get, src, "decoder.conv2", False, dtype, with_bias=False),
        },
    }


# ---------------------------------------------------------------------------
# the port's format: parameter tree <-> safetensors + manifest
# ---------------------------------------------------------------------------

def _to_numpy(t: torch.Tensor):
    """(array, is_bf16): bf16 tensors as their raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), True
    return t.numpy(), False


def _from_numpy(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    arr = np.array(arr)                     # own, writable copy of the mapped bytes
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _sorted_keys(tree: Any) -> Any:
    """``tree`` with the keys of every dict sorted: the order of JAX's pytree
    walk, in which the JAX package's ``save_params`` writes the leaves."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted_keys(v) for v in tree]
    return tree


def save_params(path: str, params: Any, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a parameter tree (QuantTensors included) to ``<path>.safetensors``
    and ``<path>.json``, leaves in the JAX package's order (so both packages
    write the same bytes for the same tree); ``metadata`` (e.g.
    ``{"component", "quant"}``) goes into the safetensors header."""
    tensors: Dict[str, np.ndarray] = {}
    dtype_map: Dict[str, str] = {}
    leaves: Dict[str, Any] = {}
    for name, leaf in flatten(_sorted_keys(params)).items():
        if leaf is None:
            continue
        if isinstance(leaf, QuantTensor):
            entry = {"type": "quant", "fmt": leaf.fmt, "shape": list(leaf.shape),
                     "fields": []}
            for f, a in leaf.fields().items():
                arr, bf16 = _to_numpy(a)
                if bf16:
                    entry.setdefault("bf16_fields", []).append(f)
                    dtype_map[f"{name}#{f}"] = "BF16"
                tensors[f"{name}#{f}"] = arr
                entry["fields"].append(f)
            leaves[name] = entry
            continue
        arr, bf16 = _to_numpy(leaf)
        tensors[name] = arr
        if bf16:
            dtype_map[name] = "BF16"
        leaves[name] = {"type": "bf16" if bf16 else "array"}
    save_safetensors(path + ".safetensors", tensors, metadata, dtype_map)
    with open(path + ".json", "w") as f:
        json.dump({"leaves": leaves}, f)


def load_params(path: str, device="cpu") -> Any:
    """Read a tree written by :func:`save_params` (or by the JAX package's
    ``save_params``), moving each tensor to ``device`` as it is read."""
    st = SafetensorsFile(path + ".safetensors")
    with open(path + ".json") as f:
        manifest = json.load(f)
    root: Dict[str, Any] = {}
    for name, entry in manifest["leaves"].items():
        if entry["type"] == "quant":
            bf16 = set(entry.get("bf16_fields", []))
            leaf = QuantTensor(entry["fmt"], tuple(entry["shape"]), **{
                f: _from_numpy(st.tensor(f"{name}#{f}"), f in bf16, device)
                for f in entry["fields"]})
        else:
            leaf = _from_numpy(st.tensor(name), entry["type"] == "bf16", device)
        *parents, last = name.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)
