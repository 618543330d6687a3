#!/usr/bin/env python3
"""Session drive of the port: a real ApiServer (with the LoRA runtime and the
training manager) in front of a tiny random-weight engine, driven over HTTP as
the studio page does: /health, the /studio page, generation with lyrics and
the LRC, the same seed giving the same audio and a new seed new audio, and
/v1/stats.  The port's counterpart of tools/verify_e2e_session.py.

    python3 tools/verify_e2e_session_torch.py [--device cuda|cpu]

Run from the repository's root; the engine runs on the card unless
``--device cpu``.  The server listens on 127.0.0.1, on a port the system
picks.  Exits 0 and prints ``VERIFY OK`` when every check holds; else exits 1
naming the check.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from verify_serving_torch import MiniTok, get, parse_args, post, tiny_engine, wait  # noqa: E402


def gen_hash(port, seed=5):
    """(sha256 of the WAV, the result) of a 10 s job with lyrics and the LRC."""
    tid = post(port, "/release_task", {"caption": "verify melody", "lyrics": "one line",
                                       "duration": 10, "seed": seed,
                                       "return_lrc": True})["task_id"]
    res = wait(port, tid)
    if res["status"] != "completed":
        raise RuntimeError(f"job failed: {res}")
    audio = base64.b64decode(res["result"]["audio_base64"])
    return hashlib.sha256(audio).hexdigest(), res["result"]


def main(argv=None) -> int:
    args = parse_args(argv, __doc__)
    from acestep_tpu_torch.lora_runtime import LoRARuntime
    from acestep_tpu_torch.serving.api_server import ApiServer
    from acestep_tpu_torch.serving.launch import make_generate_fn
    from acestep_tpu_torch.serving.training_manager import TrainingManager

    engine, base = tiny_engine(args.device)
    srv = ApiServer(make_generate_fn(engine, tokenizer=MiniTok()),
                    lora_runtime=LoRARuntime(engine, base),
                    training_manager=TrainingManager(device=args.device), api_key="")
    port = srv.start(port=0)
    print(f"[verify] server on :{port}, engine on {engine.device}")
    checks = []

    def check(ok, what):
        checks.append(what)
        if not ok:
            raise AssertionError(what)

    try:
        check(json.loads(get(port, "/health"))["status"] == "ok", "/health is ok")
        check(b"lrc" in get(port, "/studio").lower(), "/studio serves the page")
        h1, res1 = gen_hash(port, seed=5)
        check(res1.get("lrc", "").startswith("[00:"), "the result carries the LRC")
        h2, _ = gen_hash(port, seed=5)
        check(h1 == h2, "the same seed gives the same audio")
        h3, _ = gen_hash(port, seed=6)
        check(h3 != h1, "another seed gives other audio")
        stats = json.loads(get(port, "/v1/stats"))
        check(stats["completed"] >= 3, f"/v1/stats counts the jobs ({stats})")
    except (AssertionError, RuntimeError, TimeoutError) as exc:
        print(f"[verify] FAILED: {exc} (passed: {checks[:-1]})")
        return 1
    finally:
        srv.stop()
    print(f"VERIFY OK: deterministic audio {h1[:16]}, {stats['completed']} jobs completed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
