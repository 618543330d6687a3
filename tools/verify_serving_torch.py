#!/usr/bin/env python3
"""Serving drive of the port: a real ApiServer in front of a tiny random-weight
engine, driven over HTTP with the requests the studio page sends:
release_task -> query_result polled -> the result's audio_base64 WAV.  The
port's counterpart of tools/verify_serving.py.

    python3 tools/verify_serving_torch.py [--device cuda|cpu]

Run from the repository's root; the engine runs on the card unless
``--device cpu``.  The server listens on 127.0.0.1, on a port the system
picks.  Exits 0 and prints ``VERIFY OK`` when the job completes with a RIFF
WAV; else exits 1.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# tests/test_pipeline.py's tiny configs (that module imports JAX)
TINY_DIT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=16, in_channels=24,
                audio_acoustic_hidden_dim=8, patch_size=2, sliding_window=8,
                text_hidden_dim=32, num_lyric_encoder_hidden_layers=1,
                num_timbre_encoder_hidden_layers=1, timbre_hidden_dim=8)
TINY_VAE = dict(audio_channels=2, encoder_hidden_size=16, decoder_channels=8,
                decoder_input_channels=8, downsampling_ratios=(2, 4, 4),
                channel_multiples=(1, 2, 4))
TINY_TEXT = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=2, intermediate_size=64, head_dim=16)
POLL_S = 0.05


class MiniTok:
    """Bytes as token ids below the tiny text encoder's vocabulary."""

    def encode(self, text):
        return [b % 250 for b in text.encode()][:64]


def tiny_engine(device):
    """(engine, its unstacked DiT tree) on ``device``: random bf16 weights drawn
    by a seeded generator there."""
    from acestep_tpu_torch.config import DiTConfig, QwenConfig, VAEConfig
    from acestep_tpu_torch.models.random_init import RandomInit
    from acestep_tpu_torch.models.stacking import unstack_layer_params
    from acestep_tpu_torch.pipeline import AceStepEngine, resolve_device

    dev = resolve_device(device)
    dit_cfg, vae_cfg = DiTConfig(**TINY_DIT), VAEConfig(**TINY_VAE)
    text_cfg = QwenConfig(**TINY_TEXT)
    init = RandomInit(dev, 0, None)
    tree = init.dit(dit_cfg)
    base = dict(tree, layers=unstack_layer_params(tree["layers"]))
    engine = AceStepEngine(base, dit_cfg, init.vae(vae_cfg), vae_cfg, init.qwen(text_cfg),
                           text_cfg, device=dev)
    return engine, base


def post(port, path, payload, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.read()


def wait(port, task_id, limit_s=600.0):
    """Poll /query_result until the job ends; its final answer."""
    deadline = time.time() + limit_s
    while time.time() < deadline:
        res = post(port, "/query_result", {"task_id": task_id})
        if res.get("status") in ("completed", "failed"):
            return res
        time.sleep(POLL_S)
    raise TimeoutError(f"job {task_id} did not end in {limit_s} s")


def parse_args(argv, doc):
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    from acestep_tpu_torch.serving.api_server import ApiServer
    from acestep_tpu_torch.serving.launch import make_generate_fn

    engine, _ = tiny_engine(args.device)
    srv = ApiServer(make_generate_fn(engine, tokenizer=MiniTok()), api_key="")
    port = srv.start(port=0)
    print(f"[verify] server on :{port}, engine on {engine.device}")
    try:
        tid = post(port, "/release_task",
                   {"caption": "soft piano", "duration": 10, "seed": 3})["task_id"]
        res = wait(port, tid)
        if res["status"] != "completed":
            print("[verify] FAILED:", res)
            return 1
        data = base64.b64decode(res["result"]["audio_base64"])
        if data[:4] != b"RIFF":
            print(f"[verify] not a WAV: {data[:16]!r}")
            return 1
        print(f"[verify] wav {len(data)} bytes sha1 {hashlib.sha1(data).hexdigest()[:12]}")
        print("VERIFY OK")
        return 0
    finally:
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
