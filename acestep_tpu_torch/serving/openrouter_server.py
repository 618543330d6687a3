"""OpenAI Chat-Completions-compatible music API: port of the JAX package's
serving/openrouter_server.py, the same routes and payloads.

POST /v1/chat/completions with messages: the last user message is parsed into
generation parameters (free text becomes the caption; ``key: value`` lines
set metadata; from a ``[verse]``-style section on, lines are lyrics; explicit
``<prompt>`` / ``<lyrics>`` tags win).  The response carries base64 WAV
audio in the message and the generation metadata as its content, whole or
streamed as server-sent events.  GET /v1/models lists the music "models".
"""

from __future__ import annotations

import base64
import json
import os
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

META_LINE = re.compile(r"^(bpm|duration|keyscale|timesignature|language|genres)\s*:\s*(.+)$",
                       re.IGNORECASE)
SECTION = re.compile(r"^\[(verse|chorus|bridge|intro|outro|inst|hook|pre-chorus)[^\]]*\]",
                     re.IGNORECASE)

# model catalogue with capabilities and pricing (prices from the environment);
# the ids are the JAX server's, so clients address either server alike
MODELS = [
    {
        "id": "acestep/v15-turbo-tpu",
        "object": "model",
        "name": "ACE-Step 1.5 Turbo",
        "created": 1755000000,
        "description": ("Text-to-music generation (8-step turbo diffusion). "
                        "Styles, lyrics, 10-600s durations; quantized "
                        "serving."),
        "input_modalities": ["text", "audio"],
        "output_modalities": ["audio", "text"],
        "context_length": 4096,
        "pricing": {
            "prompt": os.environ.get("ACESTEP_TPU_PRICE_PROMPT", "0"),
            "completion": os.environ.get("ACESTEP_TPU_PRICE_COMPLETION", "0"),
            "request": os.environ.get("ACESTEP_TPU_PRICE_REQUEST", "0"),
        },
        "supported_sampling_parameters": ["temperature", "top_p"],
    },
    {
        "id": "acestep/v15-base-tpu",
        "object": "model",
        "name": "ACE-Step 1.5 Base",
        "created": 1755000000,
        "description": ("Base (non-turbo) diffusion with CFG guidance; "
                        "extract/lego/complete tasks."),
        "input_modalities": ["text", "audio"],
        "output_modalities": ["audio", "text"],
        "context_length": 4096,
        "pricing": {
            "prompt": os.environ.get("ACESTEP_TPU_PRICE_PROMPT", "0"),
            "completion": os.environ.get("ACESTEP_TPU_PRICE_COMPLETION", "0"),
            "request": os.environ.get("ACESTEP_TPU_PRICE_REQUEST", "0"),
        },
        "supported_sampling_parameters": ["temperature", "top_p"],
    },
]


TAG_PROMPT = re.compile(r"<prompt>(.*?)</prompt>", re.DOTALL | re.IGNORECASE)
TAG_LYRICS = re.compile(r"<lyrics>(.*?)</lyrics>", re.DOTALL | re.IGNORECASE)


def parse_chat_messages(messages: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Last user message -> {caption, lyrics, metadata}.

    Explicit ``<prompt>``/``<lyrics>`` tags take precedence over the
    line-heuristic parse."""
    user_text = ""
    for m in reversed(messages):
        if m.get("role") == "user":
            c = m.get("content", "")
            if isinstance(c, list):  # multi-part content
                c = " ".join(p.get("text", "") for p in c if p.get("type") == "text")
            user_text = c
            break

    tp = TAG_PROMPT.search(user_text)
    tl = TAG_LYRICS.search(user_text)
    if tp or tl:
        return {
            "caption": (tp.group(1).strip() if tp else ""),
            "lyrics": (tl.group(1).strip() if tl else ""),
            "metadata": {},
        }

    metadata: Dict[str, Any] = {}
    caption_lines: List[str] = []
    lyric_lines: List[str] = []
    in_lyrics = False
    for line in user_text.split("\n"):
        stripped = line.strip()
        m = META_LINE.match(stripped)
        if m and not in_lyrics:
            key = m.group(1).lower()
            val = m.group(2).strip()
            if key in ("bpm", "duration"):
                try:
                    metadata[key] = int(float(val))
                except ValueError:
                    pass
            else:
                metadata[key] = val
            continue
        if SECTION.match(stripped):
            in_lyrics = True
        if in_lyrics:
            lyric_lines.append(line)
        elif stripped:
            caption_lines.append(stripped)
    return {
        "caption": " ".join(caption_lines).strip(),
        "lyrics": "\n".join(lyric_lines).strip(),
        "metadata": metadata,
    }


def wav_base64(audio, sample_rate: int) -> str:
    """Float (or int16) audio [L, C] as base64 16-bit WAV."""
    import numpy as np

    from acestep_tpu_torch.utils.audio import wav_bytes

    return base64.b64encode(wav_bytes(np.asarray(audio), sample_rate)).decode()


class OpenRouterServer:
    """generate_fn(parsed: dict) -> {"audio": [L,C] float, "sample_rate": int,
    "metadata": dict}."""

    def __init__(self, generate_fn: Callable[[Dict[str, Any]], Dict[str, Any]]):
        self.generate_fn = generate_fn
        self._httpd: Optional[ThreadingHTTPServer] = None

    def _make_handler(server):  # noqa: N805
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/models":
                    return self._send(200, {"object": "list", "data": MODELS})
                return self._send(404, {"error": {"message": "not found"}})

            def _send_sse(self, obj):
                self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
                self.wfile.flush()

            def _stream_completion(self, body, parsed):
                """SSE streaming chunks:
                role delta -> status deltas while generating -> metadata
                content + audio delta -> finish chunk -> [DONE]."""
                import queue as _q

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                cid = f"gen-{uuid.uuid4().hex}"
                model = body.get("model", MODELS[0]["id"])

                def chunk(delta, finish=None):
                    return {
                        "id": cid, "object": "chat.completion.chunk",
                        "created": int(time.time()), "model": model,
                        "choices": [{
                            "index": 0, "delta": delta, "finish_reason": finish,
                        }],
                    }

                result_q: "_q.Queue" = _q.Queue()

                def run():
                    try:
                        result_q.put(("ok", server.generate_fn(parsed)))
                    except Exception as e:  # noqa: BLE001
                        result_q.put(("err", str(e)))

                t0 = time.time()
                threading.Thread(target=run, daemon=True).start()
                self._send_sse(chunk({"role": "assistant"}))
                while True:
                    try:
                        status, out = result_q.get(timeout=1.0)
                        break
                    except _q.Empty:
                        self._send_sse(chunk(
                            {"status": "generating",
                             "elapsed_s": round(time.time() - t0, 1)}))
                if status == "err":
                    self._send_sse(chunk({"content": json.dumps({"error": out})},
                                         finish="stop"))
                else:
                    audio_b64 = wav_base64(out["audio"], out["sample_rate"])
                    self._send_sse(chunk({
                        "content": json.dumps(out.get("metadata", {})),
                        "audio": {"data": audio_b64, "format": "wav"},
                    }))
                    self._send_sse(chunk({}, finish="stop"))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

            def do_POST(self):
                if self.path != "/v1/chat/completions":
                    return self._send(404, {"error": {"message": "not found"}})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    parsed = parse_chat_messages(body.get("messages", []))
                    if body.get("stream"):
                        return self._stream_completion(body, parsed)
                    t0 = time.time()
                    out = server.generate_fn(parsed)
                    audio_b64 = wav_base64(out["audio"], out["sample_rate"])
                    resp = {
                        "id": f"gen-{uuid.uuid4().hex}",
                        "object": "chat.completion",
                        "created": int(time.time()),
                        "model": body.get("model", MODELS[0]["id"]),
                        "choices": [{
                            "index": 0,
                            "finish_reason": "stop",
                            "message": {
                                "role": "assistant",
                                "content": json.dumps(out.get("metadata", {})),
                                "audio": {
                                    "data": audio_b64,
                                    "format": "wav",
                                },
                            },
                        }],
                        "usage": {"generation_time_s": round(time.time() - t0, 3)},
                    }
                    return self._send(200, resp)
                except Exception as e:  # noqa: BLE001
                    return self._send(500, {"error": {"message": str(e)}})

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8001) -> int:
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
