"""Audio-code <-> latent bridge in PyTorch: port of the JAX package's
models/codec.py (FSQ codebook, 5 Hz -> 25 Hz detokenizer and its inverse).

Two directions, as the reference uses them:
  * LM codes -> 25 Hz latent hints (``codes_to_latents``): the code-hint
    branch of ``inference.generate_music`` makes a text2music request a cover
    of those hints;
  * latents -> 5 Hz codes (``tokenize``): ``inference.understand_audio``.

The checkpoint's detokenizer is not published, so the module carries the
JAX package's three candidate architectures (``conv_v1``, ``fsq_linear``,
``rfsq_conv``), each with its checkpoint tensor spec; ``load_from_checkpoint``
maps a checkpoint's tensors onto the first complete spec (or the one pinned)
and raises :class:`CodecMismatchError` with the name diff otherwise.  The
finite-scalar-quantization codebook has levels [8, 8, 8, 5, 5, 5]
(64000 codes, int32 mixed radix, digit 0 fastest).

Layouts are the JAX package's: conv kernels ``[k, C_in, C_out]``, transposed
convs spatially reversed, linears ``[in, out]``; everything computes in f32
(the convs are ``models/vae``'s).  GELU is the tanh form (``jax.nn.gelu``'s
default).  ``torch.round`` and ``jnp.round`` both round half to even.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from acestep_tpu_torch.constants import AUDIO_CODEBOOK_SIZE, CODES_PER_LATENT, LATENT_DIM
from acestep_tpu_torch.models.vae import conv1d, conv_transpose1d

FSQ_LEVELS = (8, 8, 8, 5, 5, 5)          # prod = 64000 = codebook size
assert math.prod(FSQ_LEVELS) == AUDIO_CODEBOOK_SIZE


# ---------------------------------------------------------------------------
# FSQ codebook (weight-free)
# ---------------------------------------------------------------------------

def indices_to_values(indices: torch.Tensor) -> torch.Tensor:
    """Code index [..] -> FSQ values [.., 6] in [-1, 1] (mixed-radix digits,
    dim 0 fastest)."""
    vals = []
    rem = indices.to(torch.int32)
    for lvl in FSQ_LEVELS:
        digit = torch.remainder(rem, lvl)
        rem = torch.div(rem, lvl, rounding_mode="floor")
        vals.append(2.0 * digit.float() / (lvl - 1) - 1.0)
    return torch.stack(vals, dim=-1)


def values_to_indices(values: torch.Tensor) -> torch.Tensor:
    """FSQ values [.., 6] (any reals) -> the nearest code index [..] (int32)."""
    idx = torch.zeros(values.shape[:-1], dtype=torch.int32, device=values.device)
    mult = 1
    for i, lvl in enumerate(FSQ_LEVELS):
        digit = torch.clamp(torch.round((values[..., i] + 1.0) * (lvl - 1) / 2.0), 0, lvl - 1)
        idx = idx + digit.to(torch.int32) * mult
        mult *= lvl
    return idx


# ---------------------------------------------------------------------------
# random parameters (tests, the card's smoke run)
# ---------------------------------------------------------------------------

def _conv_p(gen, kw, cin, cout, device):
    w = torch.randn((kw, cin, cout), generator=gen, device=device) / math.sqrt(kw * cin)
    return {"w": w, "b": torch.zeros(cout, device=device)}


def _lin_p(gen, cin, cout, device):
    w = torch.randn((cin, cout), generator=gen, device=device) / math.sqrt(cin)
    return {"w": w, "b": torch.zeros(cout, device=device)}


def init_arch_params(arch: str, seed: int = 0, hidden: int = 256,
                     latent_dim: Optional[int] = None, device="cpu") -> Dict[str, Any]:
    """Random f32 parameters of any registered arch (codec.py:95; the JAX
    package's shapes and scales, a seeded torch.Generator's draws on
    ``device``); ``conv_v1`` keeps its flat layout, the others nest under
    ``"arch:<name>"``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, ld = len(FSQ_LEVELS), latent_dim or LATENT_DIM
    if arch == "conv_v1":
        return {
            "proj_in": _conv_p(gen, 1, d, hidden, device),
            "up": _conv_p(gen, 3 * CODES_PER_LATENT, hidden, hidden, device),
            "res1": _conv_p(gen, 3, hidden, hidden, device),
            "res2": _conv_p(gen, 3, hidden, hidden, device),
            "proj_out": _conv_p(gen, 1, hidden, ld, device),
            "down": _conv_p(gen, 3 * CODES_PER_LATENT, ld, hidden, device),
            "tok_out": {"w": torch.randn((1, hidden, d), generator=gen, device=device) * 0.05,
                        "b": torch.zeros(d, device=device)},
        }
    if arch == "fsq_linear":
        tree = {"project_in": _lin_p(gen, ld, d, device),
                "project_out": _lin_p(gen, d, ld, device),
                "det0": _conv_p(gen, 5, ld, hidden, device),
                "det2": _conv_p(gen, 5, hidden, ld, device)}
    elif arch == "rfsq_conv":
        tree = {"project_in": _lin_p(gen, ld, d, device),
                "project_out": _lin_p(gen, d, ld, device),
                "up": _conv_p(gen, 3 * CODES_PER_LATENT, ld, hidden, device),
                "post": _conv_p(gen, 3, hidden, ld, device)}
    else:
        raise ValueError(f"unknown codec arch {arch!r}")
    return wrap_arch(arch, tree)


# ---------------------------------------------------------------------------
# checkpoint tensors: (param path, checkpoint name stem, torch layout kind)
#   conv    Conv1d          [out, in, k] -> [k, in, out]
#   conv_t  ConvTranspose1d [in, out, k] -> reversed [k, in, out]
#   linear  Linear          [out, in]    -> [in, out]
# ---------------------------------------------------------------------------

CODEC_TENSOR_SPEC = (
    ("proj_in", "detokenizer.proj_in", "conv"),
    ("up", "detokenizer.up", "conv_t"),
    ("res1", "detokenizer.res1", "conv"),
    ("res2", "detokenizer.res2", "conv"),
    ("proj_out", "detokenizer.proj_out", "conv"),
    ("down", "tokenizer.down", "conv"),
    ("tok_out", "tokenizer.out", "conv"),
)
# FSQ with projection linears; nearest 5x upsample and two k5 convs
FSQ_LINEAR_SPEC = (
    ("project_in", "tokenizer.quantizer.project_in", "linear"),
    ("project_out", "tokenizer.quantizer.project_out", "linear"),
    ("det0", "detokenizer.net.0", "conv"),
    ("det2", "detokenizer.net.2", "conv"),
)
# ResidualFSQ with one quantizer; ConvTranspose1d 5x upsample and a post conv
RFSQ_CONV_SPEC = (
    ("project_in", "tokenizer.quantizer.layers.0.project_in", "linear"),
    ("project_out", "tokenizer.quantizer.layers.0.project_out", "linear"),
    ("up", "detokenizer.up.0", "conv_t"),
    ("post", "detokenizer.post.0", "conv"),
)
CODEC_NAME_MARKERS = ("tokenizer.", "detokenizer.", "model.tokenizer.", "model.detokenizer.")
ARCH_SPECS = {"conv_v1": CODEC_TENSOR_SPEC, "fsq_linear": FSQ_LINEAR_SPEC,
              "rfsq_conv": RFSQ_CONV_SPEC}


def get_arch(params: Dict[str, Any]) -> Tuple[str, Dict[str, Any]]:
    """(arch name, its parameter subtree); a flat tree is ``conv_v1``."""
    for k in params:
        if k.startswith("arch:"):
            return k[5:], params[k]
    return "conv_v1", params


def wrap_arch(arch: str, tree: Dict[str, Any]) -> Dict[str, Any]:
    return tree if arch == "conv_v1" else {f"arch:{arch}": tree}


class CodecMismatchError(RuntimeError):
    """A checkpoint's codec tensors that no spec maps: the diff is the message."""

    def __init__(self, missing, found, shape_errors):
        self.missing, self.found, self.shape_errors = missing, found, shape_errors
        lines = ["codec tensors present in checkpoint but not loadable:"]
        if missing:
            lines.append("  expected (missing): " + ", ".join(sorted(missing)))
        if found:
            lines.append("  found in checkpoint: " + ", ".join(sorted(found)[:40]))
        lines += [f"  shape mismatch: {e}" for e in shape_errors]
        lines.append("  fix: pin a variant with a codec.arch override in the "
                     "checkpoint's config.json (available: "
                     + ", ".join(sorted(ARCH_SPECS)) + "), and/or add a "
                     "codec.name_map block mapping the checkpoint names onto "
                     "that arch's spec stems (models/codec.py ARCH_SPECS); or "
                     "pass --allow-random-codec to keep the structural bridge.")
        super().__init__("\n".join(lines))


def probe_tensor_names(names) -> list:
    """The checkpoint names that belong to the codec families."""
    return sorted(n for n in names if n.startswith(CODEC_NAME_MARKERS)
                  or ".quantizer." in n or n.startswith("quantizer."))


def _torch_to_ours(w: np.ndarray, kind: str):
    """A checkpoint tensor in torch layout -> ours (None and a reason on a
    rank mismatch)."""
    if kind == "linear":
        if w.ndim != 2:
            return None, f"expected 2-d linear weight, got {w.shape}"
        return w.T.copy(), None
    if w.ndim != 3:
        return None, f"expected 3-d conv weight, got {w.shape}"
    if kind == "conv_t":
        return w.transpose(2, 0, 1)[::-1].copy(), None
    return w.transpose(2, 1, 0).copy(), None


def _ours_to_torch(w: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of :func:`_torch_to_ours`."""
    if kind == "linear":
        return np.asarray(w).T.copy()
    if kind == "conv_t":
        return np.asarray(w)[::-1].transpose(1, 2, 0).copy()
    return np.asarray(w).transpose(2, 1, 0).copy()


def _load_spec(st, spec, name_map, names, device):
    missing, shape_errors, params = [], [], {}
    for path, stem, kind in spec:
        src = name_map.get(stem, stem)
        cand = [src, "model." + src]     # remote-code modules hang off the model
        w_name = next((c + ".weight" for c in cand if c + ".weight" in names), None)
        if w_name is None:
            missing.append(stem + ".weight")
            continue
        w, err = _torch_to_ours(np.asarray(st.tensor(w_name, as_f32=True), np.float32), kind)
        if err is not None:
            shape_errors.append(f"{w_name}: {err}")
            continue
        b_name = next((c + ".bias" for c in cand if c + ".bias" in names), None)
        b = (np.asarray(st.tensor(b_name, as_f32=True), np.float32) if b_name
             else np.zeros((w.shape[-1],), np.float32))
        params[path] = {"w": torch.from_numpy(w).to(device),
                        "b": torch.from_numpy(np.array(b)).to(device)}
    return params, missing, shape_errors


def _sanity(arch: str, params: Dict[str, Any]):
    d = len(FSQ_LEVELS)
    errs = []
    if arch == "conv_v1":
        if params["proj_in"]["w"].shape[1] != d:
            errs.append(f"proj_in in-dim {params['proj_in']['w'].shape[1]} != FSQ dim {d}")
        if params["up"]["w"].shape[0] % CODES_PER_LATENT != 0:
            errs.append(f"up kernel {params['up']['w'].shape[0]} not a multiple "
                        f"of x{CODES_PER_LATENT} upsample stride")
    else:
        if params["project_out"]["w"].shape[0] != d:
            errs.append(f"project_out in-dim {params['project_out']['w'].shape[0]} "
                        f"!= FSQ dim {d}")
        if params["project_in"]["w"].shape[1] != d:
            errs.append(f"project_in out-dim {params['project_in']['w'].shape[1]} "
                        f"!= FSQ dim {d}")
        if arch == "rfsq_conv" and params["up"]["w"].shape[0] % CODES_PER_LATENT != 0:
            errs.append(f"up kernel {params['up']['w'].shape[0]} not a multiple "
                        f"of x{CODES_PER_LATENT} upsample stride")
    return errs


def load_from_checkpoint(st, name_map: Optional[Dict[str, str]] = None,
                         arch: Optional[str] = None, device="cpu") -> Dict[str, Any]:
    """The codec tree from a checkpoint's tensors (``st``: ``keys()`` and
    ``tensor(name, as_f32=True)``, as ``utils.safetensors_io.SafetensorsFile``).
    ``name_map`` maps spec stems to the checkpoint's stems; ``arch`` pins a
    spec, else the first complete one wins.  Raises CodecMismatchError."""
    names = set(st.keys())
    present = probe_tensor_names(names)
    name_map = dict(name_map or {})
    if arch is not None and arch not in ARCH_SPECS:
        raise CodecMismatchError([], present, [f"unknown codec.arch {arch!r}; available: "
                                               f"{', '.join(sorted(ARCH_SPECS))}"])
    per_arch = {}
    for a in ([arch] if arch is not None else list(ARCH_SPECS)):
        params, missing, shape_errors = _load_spec(st, ARCH_SPECS[a], name_map, names, device)
        if not missing and not shape_errors:
            errs = _sanity(a, params)
            if errs:
                raise CodecMismatchError([], present, [f"[{a}] {e}" for e in errs])
            return wrap_arch(a, params)
        per_arch[a] = (missing, shape_errors)
    detail = []
    for a, (missing, shape_errors) in per_arch.items():
        if missing:
            detail.append(f"[{a}] missing: " + ", ".join(sorted(missing)[:10]))
        detail += [f"[{a}] {e}" for e in shape_errors]
    raise CodecMismatchError([m for ml, _ in per_arch.values() for m in ml], present, detail)


def to_checkpoint_tensors(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The tree as torch-layout checkpoint tensors under the arch's names."""
    arch, p = get_arch(params)
    out: Dict[str, np.ndarray] = {}
    for path, stem, kind in ARCH_SPECS[arch]:
        out[stem + ".weight"] = _ours_to_torch(p[path]["w"].detach().float().cpu().numpy(), kind)
        out[stem + ".bias"] = p[path]["b"].detach().float().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# the two directions, per arch
# ---------------------------------------------------------------------------

def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _detok_conv_v1(p, code_indices):
    v = indices_to_values(code_indices)                  # [B, T5, 6]
    x = conv1d(v, p["proj_in"]["w"], p["proj_in"]["b"])
    x = conv_transpose1d(_gelu(x), p["up"]["w"], p["up"]["b"], stride=CODES_PER_LATENT,
                         padding=CODES_PER_LATENT)
    x = x + conv1d(_gelu(x), p["res1"]["w"], p["res1"]["b"], padding=1)
    x = x + conv1d(_gelu(x), p["res2"]["w"], p["res2"]["b"], padding=1)
    return conv1d(x, p["proj_out"]["w"], p["proj_out"]["b"])


def _tok_conv_v1(p, latents):
    t5 = latents.shape[1] // CODES_PER_LATENT
    x = conv1d(latents[:, : t5 * CODES_PER_LATENT], p["down"]["w"], p["down"]["b"],
               stride=CODES_PER_LATENT, padding=CODES_PER_LATENT)[:, :t5]
    v = conv1d(_gelu(x), p["tok_out"]["w"], p["tok_out"]["b"])
    return values_to_indices(torch.tanh(v))


def _project_out_values(p, code_indices):
    """indices -> FSQ values -> the quantizer's project_out."""
    return indices_to_values(code_indices) @ p["project_out"]["w"] + p["project_out"]["b"]


def _pool_project_in(p, latents):
    """25 Hz latents -> mean over 5 frames -> project_in -> tanh -> indices."""
    b, t25, ld = latents.shape
    t5 = t25 // CODES_PER_LATENT
    x = latents[:, : t5 * CODES_PER_LATENT].reshape(b, t5, CODES_PER_LATENT, ld).mean(dim=2)
    return values_to_indices(torch.tanh(x @ p["project_in"]["w"] + p["project_in"]["b"]))


def _detok_fsq_linear(p, code_indices):
    x = torch.repeat_interleave(_project_out_values(p, code_indices), CODES_PER_LATENT, dim=1)
    h = conv1d(x, p["det0"]["w"], p["det0"]["b"], padding=2)
    return conv1d(_gelu(h), p["det2"]["w"], p["det2"]["b"], padding=2)


def _detok_rfsq_conv(p, code_indices):
    x = conv_transpose1d(_project_out_values(p, code_indices), p["up"]["w"], p["up"]["b"],
                         stride=CODES_PER_LATENT, padding=CODES_PER_LATENT)
    return conv1d(_gelu(x), p["post"]["w"], p["post"]["b"], padding=1)


_ARCH_FWD = {
    "conv_v1": (_detok_conv_v1, _tok_conv_v1),
    "fsq_linear": (_detok_fsq_linear, _pool_project_in),
    "rfsq_conv": (_detok_rfsq_conv, _pool_project_in),
}


@torch.no_grad()
def detokenize(params: Dict[str, Any], code_indices: torch.Tensor) -> torch.Tensor:
    """[B, T5] code indices -> [B, T5 * 5, 64] latents."""
    arch, p = get_arch(params)
    return _ARCH_FWD[arch][0](p, code_indices)


@torch.no_grad()
def tokenize(params: Dict[str, Any], latents: torch.Tensor) -> torch.Tensor:
    """[B, T25, 64] latents -> [B, T25 // 5] code indices (int32)."""
    arch, p = get_arch(params)
    return _ARCH_FWD[arch][1](p, latents.float())


def codec_device(params: Dict[str, Any]) -> torch.device:
    """The device of the codec's weights (KeyError for a tree without any)."""
    for v in get_arch(params)[1].values():
        if isinstance(v, dict) and isinstance(v.get("w"), torch.Tensor):
            return v["w"].device
    raise KeyError("the codec tree holds no weight")


@torch.no_grad()
def codes_to_latents(params: Dict[str, Any], code_indices, target_frames: int) -> torch.Tensor:
    """LM codes -> latent hints [B, target_frames, 64], zero-padded or cut,
    on the codec's device (codec.py:450-476)."""
    idx = torch.as_tensor(np.asarray(code_indices), dtype=torch.int32,
                          device=codec_device(params))
    if idx.dim() == 1:
        idx = idx[None]
    lat = detokenize(params, idx)
    if lat.shape[1] < target_frames:
        lat = F.pad(lat, (0, 0, 0, target_frames - lat.shape[1]))
    return lat[:, :target_frames]
