"""The port's counterparts of the JAX package's remaining tools, on the CPU.

  * ``python -m acestep_tpu_torch.check_env --json`` exits 1 here and names
    the missing card and nvcc; with a card of capability 9.0 and nvcc faked
    in, it exits 0, and a card of another capability is refused.
  * tools/verify_serving_torch.py and tools/verify_e2e_session_torch.py print
    VERIFY OK with ``--device cpu`` (a real server on a port the system picks).
  * ``python -m acestep_tpu_torch.build_cli_token_files`` writes the JAX
    tool's bytes (tools/build_cli_token_files.py) from one tiny WordLevel
    tokenizer.json, and the prompt constants it copies are the JAX package's.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import pytest

from acestep_tpu import constants as jconst
from acestep_tpu_torch import build_cli_token_files, check_env
from acestep_tpu_torch import constants as tconst

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))


def test_check_env_without_a_card_exits_1_naming_it():
    res = _run(["-m", "acestep_tpu_torch.check_env", "--json"])
    assert res.returncode == 1, res.stderr
    info = json.loads(res.stdout)
    assert info["cards"] == [] and "mesh_shape" not in info
    assert any("no CUDA card" in p for p in info["problems"])
    assert [s["source"] for s in info["kernels"]["sources"]] == [
        f"csrc/{n}.cu" for n in ("decode_attn", "decode_mega", "dit_mega", "qmm_int8",
                                 "qmm_wgmma", "vae_resunit")]
    assert info["native_quant"]["compiles"] is True
    assert "quant" in info["settings"] and info["python"] == sys.version.split()[0]


@pytest.mark.parametrize("cap,ok", [((9, 0), True), ((8, 0), False)])
def test_check_env_takes_only_sm_90(monkeypatch, capsys, cap, ok):
    import torch

    from acestep_tpu_torch.ops.cuda import _build

    prop = types.SimpleNamespace(name="fake card", total_memory=80 * 2**30, major=cap[0],
                                 minor=cap[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: prop)
    monkeypatch.setattr(_build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(check_env, "_nvidia_smi", lambda: [["fake card", "700.00 W"]] * 2)
    rc = check_env.main(["--json"])
    info = json.loads(capsys.readouterr().out)
    assert rc == (0 if ok else 1)
    assert info["mesh_shape"] == [1, 2] and info["cards"][1]["power_limit"] == "700.00 W"
    assert info["cards"][0]["capability"] == f"{cap[0]}.{cap[1]}"
    assert info["nvcc"]["path"] == sys.executable
    assert ok or all("not sm_90" in p for p in info["problems"])
    assert "dp" in info["settings"] and "tp" in info["settings"]


@pytest.mark.parametrize("tool", ["verify_serving_torch.py", "verify_e2e_session_torch.py"])
def test_verifiers_print_verify_ok_on_the_cpu(tool):
    res = _run([f"tools/{tool}", "--device", "cpu"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "VERIFY OK" in res.stdout


def test_token_file_constants_are_the_jax_packages():
    for name in ("SFT_GEN_PROMPT", "DEFAULT_DIT_INSTRUCTION", "MAX_STYLE_TOKENS",
                 "MAX_LYRIC_TOKENS"):
        assert getattr(tconst, name) == getattr(jconst, name), name


@pytest.fixture(scope="module")
def tok_file(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["[UNK]", "dreamy", "synthwave", "la", "#", "Instruction", "Caption", "Metas",
             "bpm", ":", "105", "Fill", "the", "audio", "mask"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["</think>", "<|im_end|>", "<|endoftext|>"])
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


@pytest.mark.parametrize("case", [
    ["--caption", "dreamy synthwave", "--metas", "bpm : 105", "--lyrics", "la la la"],
    ["--caption", "dreamy", "--instruction", "Fill the mask"],
    ["--caption", "la " * 300, "--lyrics-file", "LYRICS"],
])
def test_token_files_are_the_jax_tools_bytes(tok_file, tmp_path, case):
    lyrics = tmp_path / "lyrics.txt"
    lyrics.write_text("la\n" * 2100 + "dreamy")
    args = ["--tokenizer", tok_file] + [str(lyrics) if a == "LYRICS" else a for a in case]
    ref = _run(["tools/build_cli_token_files.py", *args, "--out-dir", str(tmp_path / "jax")])
    assert ref.returncode == 0, ref.stderr
    assert build_cli_token_files.main([*args, "--out-dir", str(tmp_path / "port")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and "style_tokens.txt" in names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert len((tmp_path / "port" / "style_tokens.txt").read_text().split()) <= 256
