"""The port's checkpoint converter (acestep_tpu_torch.convert_checkpoint: the
reference importers of ``acestep_tpu_torch.loader`` and the native C++
quantizers) against the JAX package's importers and
``save_params``, on reference-layout checkpoints written here: every file the
JAX converter writes must come out bit for bit (tensors, dtypes, the
safetensors header's metadata, each leaf manifest and each ``*.config.json``).

The checkpoints carry the reference's exact tensor names (the DiT's
``decoder.*`` / ``encoder.*``, the Oobleck VAE's ``weight_v`` / ``weight_g``
pairs, the HF Qwen3 names) at two sizes: the widths of
tests/test_converter_e2e.py (no kernel reaches ``MIN_QUANT_ELEMS`` there) and
256-wide DiT and text encoders whose kernels quantize (``proj_in``, K = 384,
takes q8_0 under a 4-bit format).  The DiT's tensors are stored as bf16, the
rest as f32, as the published files.  Plus the codec bridge's cases of
test_converter_e2e.py and the converted tiny checkpoint served by the port's
``build_engine`` against the JAX engine on the JAX converter's files.
"""

import dataclasses
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from acestep_tpu import eval_metrics
from acestep_tpu import loader as jloader
from acestep_tpu import pipeline as jpipeline
from acestep_tpu import sampler as jsampler
from acestep_tpu.config import DiTConfig as JDiT, QwenConfig as JQwen, VAEConfig as JVAE
from acestep_tpu.models import codec as jcodec
from acestep_tpu.models import vae as jvae
from acestep_tpu.utils.safetensors_io import SafetensorsFile as JST
from acestep_tpu.utils.safetensors_io import f32_to_bf16_raw, save_safetensors
from acestep_tpu_torch import convert_checkpoint
from acestep_tpu_torch import loader as tloader
from acestep_tpu_torch import pipeline as tpipeline
from acestep_tpu_torch.config import DiTConfig as TDiT
from acestep_tpu_torch.models import codec as tcodec
from acestep_tpu_torch.quant import QuantTensor
from acestep_tpu_torch.quant.convert import importer_policy, quantize_tree
from acestep_tpu_torch.serving import launch
from acestep_tpu_torch.utils.safetensors_io import SafetensorsFile as TST
from acestep_tpu_torch.weights import flatten

GATE_COSINE = 0.999
GATE_SNR_DB = 26.0

TINY_DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    in_channels=24, audio_acoustic_hidden_dim=8, patch_size=2,
    sliding_window=4, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=8,
)
TINY_VAE = dict(
    audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
    decoder_input_channels=8, downsampling_ratios=[2, 4, 4],
    channel_multiples=[1, 2, 4],
)
TINY_TEXT = dict(
    vocab_size=256, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=2, intermediate_size=64,
    head_dim=16,
)
# kernels of >= 64K elements: q/o, gate/up/down, condition_embedder, proj_in
# (K = 192 * 2 = 384); k/v, lyric_embed and text_projector are smaller, and the
# timestep embeddings (time_proj 256 x 1536 too) stay bf16 in the importer
WIDE_DIT = dict(
    hidden_size=256, intermediate_size=512, num_hidden_layers=1,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    in_channels=192, audio_acoustic_hidden_dim=64, patch_size=2,
    sliding_window=4, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=1, num_timbre_encoder_hidden_layers=1,
    timbre_hidden_dim=64,
)
WIDE_TEXT = dict(
    vocab_size=256, hidden_size=256, num_hidden_layers=1,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
    head_dim=64,
)
CODEC_HIDDEN, CODEC_LD = 8, 8


# ---------------------------------------------------------------------------
# reference-layout checkpoints
# ---------------------------------------------------------------------------

def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def _ones(*shape):
    return np.ones(shape, np.float32)


def _attn(rng, t, p, h, nh, nkv, hd):
    t[p + "q_proj.weight"] = _w(rng, nh * hd, h)
    t[p + "k_proj.weight"] = _w(rng, nkv * hd, h)
    t[p + "v_proj.weight"] = _w(rng, nkv * hd, h)
    t[p + "o_proj.weight"] = _w(rng, h, nh * hd)
    t[p + "q_norm.weight"] = _ones(hd)
    t[p + "k_norm.weight"] = _ones(hd)


def _mlp(rng, t, p, h, inter):
    t[p + "gate_proj.weight"] = _w(rng, inter, h)
    t[p + "up_proj.weight"] = _w(rng, inter, h)
    t[p + "down_proj.weight"] = _w(rng, h, inter)


def _block(rng, t, p, c, attn_norms):
    h, inter = c["hidden_size"], c["intermediate_size"]
    for n in attn_norms:
        t[p + n + ".weight"] = _ones(h)
    _attn(rng, t, p + "self_attn.", h, c["num_attention_heads"], c["num_key_value_heads"],
          c["head_dim"])
    _mlp(rng, t, p + "mlp.", h, inter)


def dit_tensors(rng, c):
    h, patch = c["hidden_size"], c["patch_size"]
    t = {
        # conv1d patchify [H, C_in, patch] / convT unpatchify [H, A, patch]
        "decoder.proj_in.1.weight": _w(rng, h, c["in_channels"], patch),
        "decoder.proj_in.1.bias": _w(rng, h),
        "decoder.proj_out.1.weight": _w(rng, h, c["audio_acoustic_hidden_dim"], patch),
        "decoder.proj_out.1.bias": _w(rng, c["audio_acoustic_hidden_dim"]),
        "decoder.condition_embedder.weight": _w(rng, h, h),
        "decoder.condition_embedder.bias": _w(rng, h),
        "decoder.norm_out.weight": _ones(h),
        "decoder.scale_shift_table": _w(rng, 1, 2, h),
        "encoder.text_projector.weight": _w(rng, h, c["text_hidden_dim"]),
        "encoder.lyric_encoder.embed_tokens.weight": _w(rng, h, c["text_hidden_dim"]),
        "encoder.lyric_encoder.embed_tokens.bias": _w(rng, h),
        "encoder.lyric_encoder.norm.weight": _ones(h),
        "encoder.timbre_encoder.embed_tokens.weight": _w(rng, h, c["timbre_hidden_dim"]),
        "encoder.timbre_encoder.embed_tokens.bias": _w(rng, h),
        "encoder.timbre_encoder.norm.weight": _ones(h),
        "encoder.timbre_encoder.special_token": _w(rng, 1, 1, h),
    }
    for te in ("decoder.time_embed.", "decoder.time_embed_r."):
        t[te + "linear_1.weight"] = _w(rng, h, 256)
        t[te + "linear_1.bias"] = _w(rng, h)
        t[te + "linear_2.weight"] = _w(rng, h, h)
        t[te + "linear_2.bias"] = _w(rng, h)
        t[te + "time_proj.weight"] = _w(rng, h * 6, h)
        t[te + "time_proj.bias"] = _w(rng, h * 6)
    for i in range(c["num_hidden_layers"]):
        p = f"decoder.layers.{i}."
        t[p + "scale_shift_table"] = _w(rng, 1, 6, h)
        _block(rng, t, p, c, ("self_attn_norm", "cross_attn_norm", "mlp_norm"))
        _attn(rng, t, p + "cross_attn.", h, c["num_attention_heads"],
              c["num_key_value_heads"], c["head_dim"])
    for enc, n in (("lyric", c["num_lyric_encoder_hidden_layers"]),
                   ("timbre", c["num_timbre_encoder_hidden_layers"])):
        for i in range(n):
            _block(rng, t, f"encoder.{enc}_encoder.layers.{i}.", c,
                   ("input_layernorm", "post_attention_layernorm"))
    return t


def _wn_conv(rng, t, prefix, d0, d1, k, bias=None):
    t[prefix + ".weight_v"] = _w(rng, d0, d1, k)
    t[prefix + ".weight_g"] = np.abs(_w(rng, d0, 1, 1)) + 0.5
    if bias:
        t[prefix + ".bias"] = _w(rng, bias)


def _snake(rng, t, prefix, dim):
    t[prefix + ".alpha"] = _w(rng, 1, dim, 1)
    t[prefix + ".beta"] = _w(rng, 1, dim, 1)


def _res_unit(rng, t, prefix, dim):
    _snake(rng, t, prefix + ".snake1", dim)
    _wn_conv(rng, t, prefix + ".conv1", dim, dim, 7, dim)
    _snake(rng, t, prefix + ".snake2", dim)
    _wn_conv(rng, t, prefix + ".conv2", dim, dim, 1, dim)


def vae_tensors(rng, c):
    eh, ch = c["encoder_hidden_size"], c["decoder_channels"]
    cm = [1] + list(c["channel_multiples"])
    t = {}
    _wn_conv(rng, t, "encoder.conv1", eh, c["audio_channels"], 7, eh)
    for i, s in enumerate(c["downsampling_ratios"]):
        cin, cout = eh * cm[i], eh * cm[i + 1]
        p = f"encoder.block.{i}"
        for r in ("res_unit1", "res_unit2", "res_unit3"):
            _res_unit(rng, t, f"{p}.{r}", cin)
        _snake(rng, t, p + ".snake1", cin)
        _wn_conv(rng, t, p + ".conv1", cout, cin, 2 * s, cout)
    _snake(rng, t, "encoder.snake1", eh * cm[-1])
    _wn_conv(rng, t, "encoder.conv2", eh, eh * cm[-1], 3, eh)
    strides = list(reversed(c["downsampling_ratios"]))
    _wn_conv(rng, t, "decoder.conv1", ch * cm[-1], c["decoder_input_channels"], 7, ch * cm[-1])
    for i, s in enumerate(strides):
        cin, cout = ch * cm[len(strides) - i], ch * cm[len(strides) - i - 1]
        p = f"decoder.block.{i}"
        _snake(rng, t, p + ".snake1", cin)
        _wn_conv(rng, t, p + ".conv_t1", cin, cout, 2 * s, cout)   # convT [in, out, k]
        for r in ("res_unit1", "res_unit2", "res_unit3"):
            _res_unit(rng, t, f"{p}.{r}", cout)
    _snake(rng, t, "decoder.snake1", ch)
    _wn_conv(rng, t, "decoder.conv2", c["audio_channels"], ch, 7)
    return t


def qwen_tensors(rng, c, base="model.", lm_head=False):
    h = c["hidden_size"]
    t = {base + "embed_tokens.weight": _w(rng, c["vocab_size"], h),
         base + "norm.weight": _ones(h)}
    for i in range(c["num_hidden_layers"]):
        _block(rng, t, f"{base}layers.{i}.", c, ("input_layernorm", "post_attention_layernorm"))
    if lm_head:
        t["lm_head.weight"] = _w(rng, c["vocab_size"], h)
    return t


def codec_tensors(rng, up_stem="detokenizer.up"):
    """The conv_v1 codec's tensors in torch layouts under the canonical stems."""
    h, ld = CODEC_HIDDEN, CODEC_LD
    t = {"detokenizer.proj_in.weight": _w(rng, h, 6, 1), up_stem + ".weight": _w(rng, h, h, 15),
         "detokenizer.res1.weight": _w(rng, h, h, 3), "detokenizer.res2.weight": _w(rng, h, h, 3),
         "detokenizer.proj_out.weight": _w(rng, ld, h, 1),
         "tokenizer.down.weight": _w(rng, h, ld, 15), "tokenizer.out.weight": _w(rng, 6, h, 1)}
    for stem, n in (("detokenizer.proj_in", h), (up_stem, h), ("detokenizer.res1", h),
                    ("detokenizer.res2", h), ("detokenizer.proj_out", ld),
                    ("tokenizer.down", h), ("tokenizer.out", 6)):
        t[stem + ".bias"] = _w(rng, n)
    return t


def write_checkpoint(d, tensors, cfg, bf16=False):
    """``d/model.safetensors`` (f32, or bf16 raw bits) and ``d/config.json``."""
    os.makedirs(d, exist_ok=True)
    dtype_map = {}
    if bf16:
        tensors = {k: f32_to_bf16_raw(v) for k, v in tensors.items()}
        dtype_map = {k: "BF16" for k in tensors}
    save_safetensors(os.path.join(d, "model.safetensors"), tensors, None, dtype_map)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return d


# ---------------------------------------------------------------------------
# the JAX converter's files, in process, and the comparison
# ---------------------------------------------------------------------------

def _cfg(path, cls):
    with open(os.path.join(path, "config.json")) as f:
        return cls.from_dict(json.load(f))


def jax_convert(out, quant, dit=None, vae=None, text=None, lm=None, lm_quant=None):
    """What tools/convert_checkpoint.py writes per component, through the JAX
    importers and save_params (a codec block left to the codec tests)."""
    os.makedirs(out, exist_ok=True)
    q = None if quant == "bf16" else quant
    lq = lm_quant or q
    jobs = (("dit", dit, lambda st, c: jloader.load_dit(st, c, quant=q), JDiT),
            ("vae", vae, lambda st, c: jloader.load_vae(st, c), JVAE),
            ("text_encoder", text, lambda st, c: jloader.load_qwen(st, c, quant=q), JQwen),
            ("lm", lm, lambda st, c: jloader.load_qwen(st, c, quant=lq), JQwen))
    names = []
    for name, path, fn, cls in jobs:
        if path is None:
            continue
        cfg = _cfg(path, cls)
        params = fn(JST(os.path.join(path, "model.safetensors")), cfg)
        jloader.save_params(os.path.join(out, name), params, {"component": name, "quant": quant})
        with open(os.path.join(out, f"{name}.config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1)
        names.append(name)
    return names


def port_convert(out, quant, dit=None, vae=None, text=None, lm=None, lm_quant=None,
                 extra=()):
    argv = ["--out", out, "--quant", quant, *extra]
    for flag, path in (("--dit", dit), ("--vae", vae), ("--text", text), ("--lm", lm)):
        if path is not None:
            argv += [flag, path]
    if lm_quant:
        argv += ["--lm-quant", lm_quant]
    return convert_checkpoint.main(argv)


def _differing_tensor(a, b):
    ha, hb = JST(a), JST(b)
    if ha.metadata != hb.metadata:
        return f"metadata {ha.metadata} != {hb.metadata}"
    if list(ha.keys()) != list(hb.keys()):
        return f"names {sorted(set(ha.keys()) ^ set(hb.keys()))[:8]} / order"
    for n in ha.keys():
        if ha.header[n] != hb.header[n]:
            return f"{n}: {ha.header[n]} != {hb.header[n]}"
        if not np.array_equal(ha.tensor(n).view(np.uint8), hb.tensor(n).view(np.uint8)):
            return f"{n}: values"
    return "the header's padding"


def assert_same_files(ref_dir, got_dir, names):
    for name in names:
        for suffix in (".safetensors", ".json", ".config.json"):
            a, b = os.path.join(ref_dir, name + suffix), os.path.join(got_dir, name + suffix)
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
            if not same and suffix == ".safetensors":
                pytest.fail(f"{name}{suffix} differs: {_differing_tensor(a, b)}")
            assert same, f"{name}{suffix} differs"


def _manifest(out):
    with open(os.path.join(out, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(0)
    return {
        "tiny dit": write_checkpoint(str(root / "tiny_dit"), dit_tensors(rng, TINY_DIT), TINY_DIT),
        "tiny vae": write_checkpoint(str(root / "tiny_vae"), vae_tensors(rng, TINY_VAE), TINY_VAE),
        "tiny text": write_checkpoint(str(root / "tiny_text"), qwen_tensors(rng, TINY_TEXT),
                                      TINY_TEXT),
        "wide dit": write_checkpoint(str(root / "wide_dit"), dit_tensors(rng, WIDE_DIT),
                                     WIDE_DIT, bf16=True),
        "wide text": write_checkpoint(str(root / "wide_text"), qwen_tensors(rng, WIDE_TEXT),
                                      WIDE_TEXT),
    }


@pytest.mark.parametrize("size,quant", [("tiny", "q8_0")] + [
    ("wide", q) for q in ("bf16", "q8_0", "q4_0", "q4_k", "q6_k")])
def test_converter_writes_the_jax_bytes(sources, tmp_path, size, quant):
    src = dict(dit=sources[f"{size} dit"], vae=sources["tiny vae"], text=sources[f"{size} text"])
    names = jax_convert(str(tmp_path / "jax"), quant, **src)
    assert port_convert(str(tmp_path / "port"), quant, **src) == 0
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), names)
    m = _manifest(str(tmp_path / "port"))
    assert m["quant"] == quant and m["codec_probe"] == []
    assert {k: v["source"] for k, v in m["components"].items()} == {
        "dit": src["dit"], "vae": src["vae"], "text_encoder": src["text"]}
    assert all(isinstance(v["seconds"], float) for v in m["components"].values())
    if size == "wide" and quant != "bf16":
        tree = tloader.load_params(str(tmp_path / "port" / "dit"))
        assert tree["layers"][0]["mlp"]["down_proj"]["kernel"].fmt == quant
        assert tree["proj_in"]["kernel"].fmt == "q8_0"          # K = 384
        assert tree["time_embed"]["time_proj"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["tied", "untied", "bare prefix"])
def test_converter_lm_matches_jax(tmp_path, case):
    rng = np.random.default_rng(1)
    cfg = dict(WIDE_TEXT, tie_word_embeddings=case != "untied")
    lm = write_checkpoint(str(tmp_path / "lm"), qwen_tensors(
        rng, cfg, base="" if case == "bare prefix" else "model.", lm_head=True), cfg)
    with open(os.path.join(lm, "tokenizer.json"), "w") as f:
        f.write('{"model": {"vocab": {}}}')
    names = jax_convert(str(tmp_path / "jax"), "q4_k", lm=lm, lm_quant="q8_0")
    assert port_convert(str(tmp_path / "port"), "q4_k", lm=lm, lm_quant="q8_0") == 0
    assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"), names)
    tree = tloader.load_params(str(tmp_path / "port" / "lm"))
    assert ("lm_head" in tree) == (case == "untied")
    assert tree["layers"][0]["q_proj"]["kernel"].fmt == "q8_0"
    with open(os.path.join(lm, "tokenizer.json"), "rb") as a, \
            open(str(tmp_path / "port" / "tokenizer.json"), "rb") as b:
        assert a.read() == b.read()
    assert _manifest(str(tmp_path / "port"))["components"]["tokenizer"] == {
        "source": os.path.join(lm, "tokenizer.json")}


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_importers_quantize_what_importer_policy_picks(sources, tmp_path, monkeypatch, fmt):
    """The converter runs without a card, and the kernels it quantizes are
    those ``quantize_tree`` picks with ``importer_policy`` (``formats.quantize``
    of the f32 tree bit for bit); every other leaf is the f32 tree's, cast."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_convert(str(tmp_path), fmt, dit=sources["wide dit"]) == 0
    got = flatten(tloader.load_params(str(tmp_path / "dit")))
    st = TST(os.path.join(sources["wide dit"], "model.safetensors"))
    plain = tloader.load_dit(st, _cfg(sources["wide dit"], TDiT), quant=None,
                             dtype=torch.float32)
    want = flatten(quantize_tree(plain, fmt, importer_policy))
    assert got.keys() == want.keys()
    quantized = 0
    for name, w in want.items():
        g = got[name]
        if isinstance(w, QuantTensor):
            quantized += 1
            assert isinstance(g, QuantTensor) and g.fmt == w.fmt, name
            assert all(torch.equal(g.fields()[f], t) for f, t in w.fields().items()), name
        else:
            assert not isinstance(g, QuantTensor) and torch.equal(g, w.to(g.dtype)), name
    assert quantized and not isinstance(got["time_embed/time_proj/kernel"], QuantTensor)


def _dit_with(tmp_path, extra, cfg_extra=None, seed=1):
    """A tiny DiT checkpoint whose file also carries ``extra`` tensors."""
    rng = np.random.default_rng(seed)
    t = dit_tensors(rng, TINY_DIT)
    t.update(extra(rng) if callable(extra) else extra)
    return write_checkpoint(str(tmp_path / "dit"), t, dict(TINY_DIT, **(cfg_extra or {})))


def _jax_codec(dit_dir, out, override=None):
    """The JAX converter's codec files for ``dit_dir``."""
    override = override or {}
    st = JST(os.path.join(dit_dir, "model.safetensors"))
    probe = jcodec.probe_tensor_names(st.keys())
    params = jcodec.load_from_checkpoint(st, name_map=override.get("name_map"),
                                         arch=override.get("arch"))
    arch, _ = jcodec.get_arch(params)
    os.makedirs(out, exist_ok=True)
    jloader.save_params(os.path.join(out, "codec"), params,
                        {"component": "codec", "quant": "f32", "arch": arch})
    with open(os.path.join(out, "codec.config.json"), "w") as f:
        json.dump({"source_names": probe, "arch": arch,
                   "name_map": override.get("name_map", {})}, f, indent=1)
    return arch


def test_converter_codec_probe_and_load(tmp_path):
    dit = _dit_with(tmp_path, codec_tensors)
    out = str(tmp_path / "port")
    assert port_convert(out, "q8_0", dit=dit) == 0
    m = _manifest(out)
    assert m["components"]["codec"] == {"source": dit, "tensors": 14, "arch": "conv_v1"}
    assert len(m["codec_probe"]) == 14
    assert m["codec_probe"][0] == {"name": "detokenizer.proj_in.bias", "shape": [CODEC_HIDDEN]}
    assert _jax_codec(dit, str(tmp_path / "jax")) == "conv_v1"
    assert_same_files(str(tmp_path / "jax"), out, ["codec"])
    p = tloader.load_params(os.path.join(out, "codec"))
    assert p["proj_in"]["w"].shape == (1, 6, CODEC_HIDDEN)
    assert p["up"]["w"].shape == (15, CODEC_HIDDEN, CODEC_HIDDEN)
    lat = tcodec.detokenize(p, torch.zeros((1, 10), dtype=torch.int64))
    assert lat.shape == (1, 50, CODEC_LD) and bool(torch.isfinite(lat).all())
    assert tcodec.tokenize(p, lat).shape == (1, 10)


def test_converter_codec_mismatch_fails_loudly(tmp_path, capsys):
    dit = _dit_with(tmp_path, lambda rng: {
        "model.tokenizer.quantizer.project_in.weight": _w(rng, 6, 6),
        "detokenizer.upsampler.weight": _w(rng, 8, 8, 15)})
    out = str(tmp_path / "port")
    assert port_convert(out, "q8_0", dit=dit) == 1
    err = capsys.readouterr().err
    assert "detokenizer.proj_in.weight" in err and "codec.name_map" in err
    assert port_convert(out, "q8_0", dit=dit, extra=["--allow-random-codec"]) == 0
    codec = _manifest(out)["components"]["codec"]
    assert codec["status"] == "random"
    with pytest.raises(jcodec.CodecMismatchError) as jerr:
        jcodec.load_from_checkpoint(JST(os.path.join(dit, "model.safetensors")))
    assert codec["mismatch"] == str(jerr.value)


def test_converter_codec_name_map_override(tmp_path):
    override = {"name_map": {"detokenizer.up": "detokenizer.upsampler"}}
    dit = _dit_with(tmp_path, lambda rng: codec_tensors(rng, "detokenizer.upsampler"),
                    {"codec": override})
    out = str(tmp_path / "port")
    assert port_convert(out, "q8_0", dit=dit) == 0
    _jax_codec(dit, str(tmp_path / "jax"), override)
    assert_same_files(str(tmp_path / "jax"), out, ["codec"])
    with open(os.path.join(out, "codec.config.json")) as f:
        assert json.load(f)["name_map"] == override["name_map"]


@pytest.mark.parametrize("arch", ["conv_v1", "fsq_linear", "rfsq_conv"])
def test_converter_codec_arch_variants(tmp_path, arch):
    """Each codec architecture converts without overrides (auto-detected), as
    the JAX converter's bytes, and reproduces the source detokenizer."""
    src = tcodec.init_arch_params(arch, seed=5, hidden=CODEC_HIDDEN, latent_dim=CODEC_LD)
    dit = _dit_with(tmp_path, tcodec.to_checkpoint_tensors(src))
    out = str(tmp_path / "port")
    assert port_convert(out, "q8_0", dit=dit) == 0
    assert _jax_codec(dit, str(tmp_path / "jax")) == arch
    assert_same_files(str(tmp_path / "jax"), out, ["codec"])
    p = tloader.load_params(os.path.join(out, "codec"))
    assert tcodec.get_arch(p)[0] == arch
    idx = torch.from_numpy(np.random.default_rng(7).integers(0, 64000, (1, 10)))
    torch.testing.assert_close(tcodec.detokenize(p, idx), tcodec.detokenize(src, idx),
                               rtol=1e-6, atol=1e-6)


def test_converter_codec_arch_pin_mismatch(tmp_path, capsys):
    src = tcodec.init_arch_params("fsq_linear", seed=5, hidden=CODEC_HIDDEN,
                                  latent_dim=CODEC_LD)
    dit = _dit_with(tmp_path, tcodec.to_checkpoint_tensors(src), {"codec": {"arch": "rfsq_conv"}})
    assert port_convert(str(tmp_path / "port"), "q8_0", dit=dit) == 1
    err = capsys.readouterr().err
    assert "rfsq_conv" in err and "missing" in err


def test_converted_checkpoint_served_as_the_jax_engine(sources, tmp_path):
    """The port's engine built by build_engine from its converted tiny
    checkpoint against the JAX engine on the JAX converter's files: the same
    noise, the Q8_0 gate on the int16 waveform."""
    src = dict(dit=sources["tiny dit"], vae=sources["tiny vae"], text=sources["tiny text"])
    jax_convert(str(tmp_path / "jax"), "q8_0", **src)
    assert port_convert(str(tmp_path / "port"), "q8_0", **src) == 0
    dit_cfg, vae_cfg, text_cfg = (JDiT.from_dict(TINY_DIT), JVAE.from_dict(TINY_VAE),
                                  JQwen.from_dict(TINY_TEXT))
    rng = np.random.default_rng(4)
    t_valid = jpipeline.frames_for_duration(10.0)
    t = jpipeline.bucket_frames(t_valid)
    noise = rng.standard_normal((1, t, dit_cfg.audio_acoustic_hidden_dim)).astype(np.float32)
    style = rng.integers(0, TINY_TEXT["vocab_size"], (1, 12))
    lyric = rng.integers(0, TINY_TEXT["vocab_size"], (1, 20))

    def jparams(name):
        return jloader.load_params(str(tmp_path / "jax" / name))

    vp = jparams("vae")
    jeng = jpipeline.AceStepEngine(jparams("dit"), dit_cfg, vp, vae_cfg,
                                   jparams("text_encoder"), text_cfg)
    jreq = jpipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                       lyric_token_ids=lyric, seeds=[1])
    enc, enc_mask = jeng.build_condition(jreq, 1)
    ctx = jeng.build_context_latents(jreq, 1, t, t_valid)
    attn_mask = (jnp.arange(t)[None, :] < t_valid).astype(jnp.int32)
    lat = jsampler.sample_latents(
        jeng.dit_params, dit_cfg, jnp.asarray(noise), ctx, enc, enc_mask,
        jsampler.get_timestep_schedule(3.0), attn_mask=attn_mask, use_attn_mask=True)
    i16_ref, scale_ref = jvae.fused_tiled_decode_int16(vp, vae_cfg, lat[:, :t_valid],
                                                       chunk_frames=512)
    ref = np.asarray(i16_ref).reshape(1, -1, 2).astype(np.float32) / float(scale_ref)

    eng, dit_tree = launch.build_engine(str(tmp_path / "port"), device="cpu")
    assert isinstance(dit_tree["layers"], list)
    res = eng.generate(tpipeline.GenerationRequest(duration_s=10.0, style_token_ids=style,
                                                   lyric_token_ids=lyric, seeds=[1]),
                       noise=torch.from_numpy(noise))
    assert res.audio_i16.shape == (1, t_valid * 32, 2) and np.abs(ref).std() > 0
    cos, snr = eval_metrics.cosine(ref, res.audio), eval_metrics.snr_db(ref, res.audio)
    assert cos >= GATE_COSINE and snr >= GATE_SNR_DB, (cos, snr)
