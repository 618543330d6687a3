"""Async-job REST server, stdlib ``http.server`` only: port of the JAX
package's serving/api_server.py, the same routes and payloads.

Endpoints:
  POST /release_task          submit a generation job    -> {"task_id": ...}
  POST /query_result          poll job status/result     -> {"status", "result"}
  GET  /, /studio             the studio page (acestep_tpu_torch/ui/studio.html)
  GET  /health                liveness
  GET  /v1/models             model listing
  GET  /v1/stats              job counts, latency histograms, batcher stats
  GET  /v1/audio?path=        a file under the audio directory
  POST /create_random_sample  LM inspiration flow
  POST /format_input          LM rewrite flow
  GET  /v1/jobs               newest-first job summaries
  POST /v1/jobs/delete        drop a job from the store
  POST /v1/jobs/requeue       resubmit a job's original payload as a new job
  POST /v1/lyrics             LRC and token timestamps of a completed job
  GET/POST /v1/lora           list / register, activate, scale, deactivate,
                              unregister adapters (lora_runtime.LoRARuntime)
  POST /v1/training/start|stop, GET /v1/training/status
                              background fine-tunes (training_manager.TrainingManager)
  POST /v1/dataset/scan|build, GET /v1/dataset/status
                              dataset builds (dataset_manager.DatasetManager)
  (LoRA, training and dataset routes answer 501 where their manager is not attached)

Jobs live in an in-memory store with TTL cleanup; one worker thread drains a
FIFO queue, so generation is serialized per engine.  Optional API-key auth
(``Authorization: Bearer <key>``) from the ``ACESTEP_TPU_API_KEY`` env var;
a JSONL request log where ``ACESTEP_TPU_REQUEST_LOG`` names a file.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

JOB_TTL_S = 3600.0
CLEANUP_INTERVAL_S = 60.0


class JobStore:
    def __init__(self, ttl_s: float = JOB_TTL_S):
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._ttl = ttl_s
        self.stats = {"submitted": 0, "completed": 0, "failed": 0}

    def create(self, payload: Dict[str, Any]) -> str:
        task_id = uuid.uuid4().hex
        with self._lock:
            self._jobs[task_id] = {
                "status": "queued",
                "payload": payload,
                "result": None,
                "error": None,
                "created_at": time.time(),
                "updated_at": time.time(),
            }
            self.stats["submitted"] += 1
        return task_id

    def update(self, task_id: str, **fields) -> None:
        with self._lock:
            job = self._jobs.get(task_id)
            if job is not None:
                job.update(fields, updated_at=time.time())
                if fields.get("status") == "completed":
                    self.stats["completed"] += 1
                elif fields.get("status") == "failed":
                    self.stats["failed"] += 1

    def get(self, task_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._jobs[task_id]) if task_id in self._jobs else None

    def cleanup(self) -> int:
        now = time.time()
        with self._lock:
            stale = [k for k, v in self._jobs.items() if now - v["updated_at"] > self._ttl]
            for k in stale:
                del self._jobs[k]
        return len(stale)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            by_status: Dict[str, int] = {}
            for v in self._jobs.values():
                by_status[v["status"]] = by_status.get(v["status"], 0) + 1
        return {**self.stats, **{f"jobs_{k}": n for k, n in by_status.items()}}

    def delete(self, task_id: str) -> bool:
        """Drop a job (results-management delete; running jobs keep executing
        — the worker's update() on a deleted id is a no-op)."""
        with self._lock:
            return self._jobs.pop(task_id, None) is not None

    def list(self, limit: int = 50) -> list:
        """Newest-first job summaries for results management (no audio payload
        — completed audio is refetched per task via /query_result).  Reference
        surface: a results tab over the same job store."""
        with self._lock:
            jobs = sorted(
                self._jobs.items(), key=lambda kv: kv[1]["created_at"], reverse=True
            )[: max(1, min(int(limit), 500))]
            out = []
            for task_id, v in jobs:
                p = v.get("payload") or {}
                r = v.get("result") or {}
                out.append({
                    "task_id": task_id,
                    "status": v["status"],
                    "created_at": v["created_at"],
                    "updated_at": v["updated_at"],
                    "caption": p.get("caption") or p.get("prompt") or "",
                    "duration": p.get("duration"),
                    "seed": p.get("seed"),
                    "audio_format": r.get("audio_format"),
                    "time_costs": r.get("time_costs"),
                    "error": v.get("error"),
                })
        return out


# canonical name -> accepted aliases (camelCase / legacy keys), checked in
# payload, then its "param_obj" sub-object, then "metas" (the JAX package's
# RequestParser, acestep_tpu/serving/api_server.py:121-157)
PARAM_ALIASES = {
    "caption": ["caption", "prompt"],
    "lyrics": ["lyrics", "lyric"],
    "thinking": ["thinking", "think"],
    "sample_query": ["sample_query", "sampleQuery", "description", "desc"],
    "model": ["model", "model_name", "modelName", "dit_model", "ditModel"],
    "keyscale": ["keyscale", "key_scale", "keyScale", "key"],
    "timesignature": ["timesignature", "time_signature", "timeSignature"],
    "duration": ["duration", "audio_duration", "audioDuration",
                 "target_duration", "targetDuration"],
    "language": ["language", "vocal_language", "vocalLanguage"],
    "bpm": ["bpm"],
    "inference_steps": ["inference_steps", "inferenceSteps", "infer_steps"],
    "guidance_scale": ["guidance_scale", "guidanceScale"],
    "seed": ["seed", "seeds"],
    "use_random_seed": ["use_random_seed", "useRandomSeed"],
    "audio_cover_strength": ["audio_cover_strength", "audioCoverStrength"],
    "task_type": ["task_type", "taskType", "task"],
    "infer_method": ["infer_method", "inferMethod"],
    "batch_size": ["batch_size", "batchSize"],
    "audio_format": ["audio_format", "audioFormat", "format"],
    "constrained_decoding": ["constrained_decoding", "constrainedDecoding",
                             "constrained"],
    "lm_temperature": ["lm_temperature", "lmTemperature"],
    "lm_metadata_temperature": ["lm_metadata_temperature",
                                "lmMetadataTemperature",
                                "metadata_temperature"],
    "lm_codes_temperature": ["lm_codes_temperature", "lmCodesTemperature",
                             "codes_temperature"],
    "lm_top_p": ["lm_top_p", "lmTopP"],
    "lm_top_k": ["lm_top_k", "lmTopK"],
    "lm_cfg_scale": ["lm_cfg_scale", "lmCfgScale"],
    "lm_negative_prompt": ["lm_negative_prompt", "lmNegativePrompt"],
    "lm_num_candidates": ["lm_num_candidates", "lmNumCandidates"],
    "lm_batch_chunk_size": ["lm_batch_chunk_size", "lmBatchChunkSize"],
}


class RequestParser:
    """Alias-aware payload reader with typed getters."""

    def __init__(self, raw: Dict[str, Any]):
        self._raw = dict(raw) if raw else {}
        self._param_obj = self._as_dict(self._raw.get("param_obj"))
        self._metas = {}
        for key in ("metas", "meta", "metadata", "user_metadata", "userMetadata"):
            v = self._raw.get(key)
            if v:
                self._metas = self._as_dict(v)
                break

    @staticmethod
    def _as_dict(v) -> Dict[str, Any]:
        if isinstance(v, dict):
            return v
        if isinstance(v, str) and v.strip():
            try:
                parsed = json.loads(v)
                return parsed if isinstance(parsed, dict) else {}
            except json.JSONDecodeError:
                pass
        return {}

    def get(self, name: str, default=None):
        for source in (self._raw, self._param_obj, self._metas):
            for alias in PARAM_ALIASES.get(name, [name]):
                if source.get(alias) is not None:
                    return source[alias]
        return default

    def str(self, name: str, default: str = "") -> str:
        v = self.get(name)
        return str(v) if v is not None else default

    def int(self, name: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(name)
        try:
            return int(float(v)) if v is not None else default
        except (TypeError, ValueError):
            return default

    def float(self, name: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(name)
        try:
            return float(v) if v is not None else default
        except (TypeError, ValueError):
            return default

    def bool(self, name: str, default: bool = False) -> bool:
        v = self.get(name)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).strip().lower() in ("1", "true", "yes", "on")


class LatencyStats:
    """Per-phase latency accumulator exposed in /v1/stats.

    Keeps a bounded reservoir per metric; reports count/mean/p50/p90/p99/max
    as the JAX package's LatencyStats does."""

    MAX_SAMPLES = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, list] = {}

    def record(self, metric: str, seconds: float) -> None:
        with self._lock:
            buf = self._samples.setdefault(metric, [])
            buf.append(float(seconds))
            if len(buf) > self.MAX_SAMPLES:
                del buf[: len(buf) - self.MAX_SAMPLES]

    def record_time_costs(self, time_costs: Dict[str, Any]) -> None:
        for k, v in (time_costs or {}).items():
            if isinstance(v, (int, float)):
                self.record(k, v)

    def summary(self) -> Dict[str, Dict[str, float]]:
        def pct(sorted_buf, q):
            i = min(len(sorted_buf) - 1, int(q * (len(sorted_buf) - 1) + 0.5))
            return sorted_buf[i]

        out = {}
        with self._lock:
            for k, buf in self._samples.items():
                if not buf:
                    continue
                s = sorted(buf)
                out[k] = {
                    "count": len(s),
                    "mean": sum(s) / len(s),
                    "p50": pct(s, 0.50),
                    "p90": pct(s, 0.90),
                    "p99": pct(s, 0.99),
                    "max": s[-1],
                }
        return out


class ApiServer:
    """HTTP front over a generation callable.

    ``generate_fn(payload: dict) -> dict`` runs one job (typically wraps
    ``inference.generate_music``, see serving/launch.py); LM-only flows are
    optional callables.
    """

    def __init__(
        self,
        generate_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
        create_sample_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
        format_input_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
        models_info: Optional[Dict[str, Any]] = None,
        api_key: Optional[str] = None,
        audio_dir: Optional[str] = None,
        lora_runtime: Optional[Any] = None,
        training_manager: Optional[Any] = None,
        batcher: Optional[Any] = None,
        dataset_manager: Optional[Any] = None,
    ):
        # /v1/audio downloads are restricted to this directory (path-traversal
        # guard)
        self.audio_dir = os.path.abspath(audio_dir or os.path.join(os.getcwd(), "outputs"))
        self.generate_fn = generate_fn
        self.create_sample_fn = create_sample_fn
        self.format_input_fn = format_input_fn
        self.models_info = models_info or {"models": ["acestep-v15-turbo-tpu"]}
        self.api_key = api_key if api_key is not None else os.environ.get("ACESTEP_TPU_API_KEY")
        self.lora_runtime = lora_runtime
        self.training_manager = training_manager
        self.dataset_manager = dataset_manager
        # optional ContinuousBatcher whose merge-rate stats ride /v1/stats
        # (the worker itself stays serial; deployments that want merged
        # batches point generate_fn at batcher.submit(...).result())
        self.batcher = batcher
        self.store = JobStore()
        self.latency = LatencyStats()
        from acestep_tpu_torch.progress import ProgressEstimator

        self.progress = ProgressEstimator()
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._threads = []

    # -- worker ------------------------------------------------------------

    def _worker(self):
        while not self._stop.is_set():
            try:
                task_id = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            job = self.store.get(task_id)
            if job is None:
                continue
            eta = self.progress.estimate(job["payload"])
            self.store.update(task_id, status="running", eta_s=eta)
            t0 = time.time()
            try:
                result = self.generate_fn(job["payload"])
                wall = time.time() - t0
                self.store.update(task_id, status="completed", result=result)
                self.latency.record("job_wall", wall)
                if isinstance(result, dict):
                    self.latency.record_time_costs(result.get("time_costs"))
                self.progress.observe(job["payload"], wall)
                self._log_request(task_id, job["payload"], "completed", wall)
            except Exception as e:  # noqa: BLE001 — job errors go to the client
                self.latency.record("job_wall_failed", time.time() - t0)
                self.store.update(task_id, status="failed", error=str(e))
                self._log_request(task_id, job["payload"], "failed",
                                  time.time() - t0, error=str(e))

    def _log_request(self, task_id, payload, status, wall, error=None):
        """Structured JSONL request log (the ACESTEP_TPU_REQUEST_LOG path)."""
        path = os.environ.get("ACESTEP_TPU_REQUEST_LOG")
        if not path:
            return
        try:
            rec = {
                "ts": time.time(), "task_id": task_id, "status": status,
                "wall_s": round(wall, 3),
                "duration": payload.get("duration"),
                "task_type": payload.get("task_type", "text2music"),
            }
            if error:
                rec["error"] = error[:500]
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    def _cleaner(self):
        while not self._stop.is_set():
            self.store.cleanup()
            self._stop.wait(CLEANUP_INTERVAL_S)

    # -- http --------------------------------------------------------------

    def _make_handler(server):  # noqa: N805 — closure over the ApiServer
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, obj: Dict[str, Any]):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _auth_ok(self) -> bool:
                if not server.api_key:
                    return True
                header = self.headers.get("Authorization", "")
                return header == f"Bearer {server.api_key}"

            def _body(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", 0))
                if n == 0:
                    return {}
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                if self.path in ("/", "/studio"):
                    page = os.path.join(
                        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "ui", "studio.html",
                    )
                    try:
                        with open(page, "rb") as f:
                            body = f.read()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    except OSError:
                        return self._send(404, {"error": "studio UI missing"})
                if self.path == "/health":
                    return self._send(200, {"status": "ok"})
                if not self._auth_ok():
                    return self._send(401, {"error": "unauthorized"})
                if self.path == "/v1/models":
                    return self._send(200, server.models_info)
                if self.path == "/v1/stats":
                    out = {
                        **server.store.counts(),
                        "latency": server.latency.summary(),
                    }
                    if server.batcher is not None:
                        out["batching"] = server.batcher.stats_summary()
                    return self._send(200, out)
                if self.path.startswith("/v1/audio"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    rel = (q.get("path") or [""])[0]
                    full = os.path.abspath(os.path.join(server.audio_dir, rel))
                    if not full.startswith(server.audio_dir + os.sep):
                        return self._send(403, {"error": "forbidden path"})
                    if not os.path.isfile(full):
                        return self._send(404, {"error": "no such audio"})
                    ctype = ("audio/flac" if full.endswith(".flac")
                             else "audio/wav")
                    with open(full, "rb") as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return None
                if self.path.startswith("/v1/jobs"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    limit = int((q.get("limit") or ["50"])[0])
                    return self._send(200, {"jobs": server.store.list(limit)})
                if self.path == "/v1/lora":
                    if server.lora_runtime is None:
                        return self._send(501, {"error": "LoRA runtime not attached"})
                    return self._send(200, {"adapters": server.lora_runtime.list_adapters()})
                if self.path == "/v1/training/status":
                    if server.training_manager is None:
                        return self._send(501, {"error": "training not attached"})
                    return self._send(200, server.training_manager.status())
                if self.path == "/v1/dataset/status":
                    if server.dataset_manager is None:
                        return self._send(501, {"error": "dataset builder not attached"})
                    return self._send(200, server.dataset_manager.status())
                return self._send(404, {"error": "not found"})

            def do_POST(self):
                if not self._auth_ok():
                    return self._send(401, {"error": "unauthorized"})
                try:
                    body = self._body()
                except json.JSONDecodeError:
                    return self._send(400, {"error": "invalid json"})

                if self.path == "/release_task":
                    task_id = server.store.create(body)
                    server._queue.put(task_id)
                    return self._send(200, {"task_id": task_id, "status": "queued"})
                if self.path == "/v1/jobs/delete":
                    ok = server.store.delete(body.get("task_id", ""))
                    return self._send(200 if ok else 404,
                                      {"deleted": ok} if ok
                                      else {"error": "unknown task_id"})
                if self.path == "/v1/jobs/requeue":
                    # results-management re-run: resubmit the ORIGINAL payload
                    # as a fresh job (new seed unless the payload pinned one)
                    job = server.store.get(body.get("task_id", ""))
                    if job is None:
                        return self._send(404, {"error": "unknown task_id"})
                    payload = dict(job.get("payload") or {})
                    new_id = server.store.create(payload)
                    server._queue.put(new_id)
                    return self._send(200, {"task_id": new_id, "status": "queued"})
                if self.path == "/query_result":
                    task_id = body.get("task_id", "")
                    job = server.store.get(task_id)
                    if job is None:
                        return self._send(404, {"error": "unknown task_id"})
                    return self._send(200, {
                        "task_id": task_id,
                        "status": job["status"],
                        "result": job["result"],
                        "error": job["error"],
                        "eta_s": job.get("eta_s"),
                    })
                if self.path == "/v1/lyrics":
                    # LRC + token timestamps for a completed job (the studio's
                    # synced-lyrics display).  The aligner
                    # runs during generation when return_lrc is set — this
                    # route serves the stored result rather than re-running
                    # the cross-attention probe on latents the job store no
                    # longer holds.
                    task_id = body.get("task_id", "")
                    job = server.store.get(task_id)
                    if job is None:
                        return self._send(404, {"error": "unknown task_id"})
                    if job["status"] != "completed":
                        return self._send(409, {"error": f"job is {job['status']}"})
                    result = job.get("result") or {}
                    if not result.get("lrc"):
                        return self._send(409, {
                            "error": "job was generated without lyric "
                                     "alignment; resubmit with return_lrc "
                                     "and non-empty lyrics"})
                    return self._send(200, {
                        "task_id": task_id,
                        "lrc": result["lrc"],
                        "lyric_timestamps": result.get("lyric_timestamps"),
                        "lyric_score": result.get("lyric_score"),
                    })
                if self.path == "/create_random_sample":
                    if server.create_sample_fn is None:
                        return self._send(501, {"error": "LM not loaded"})
                    return self._send(200, server.create_sample_fn(body.get("query", "")))
                if self.path == "/format_input":
                    if server.format_input_fn is None:
                        return self._send(501, {"error": "LM not loaded"})
                    return self._send(200, server.format_input_fn(body.get("text", "")))
                if self.path == "/v1/lora":
                    # {action: register|activate|deactivate|scale|unregister,
                    #  name, path?, alpha?, scale?} (core/lora/service.py surface)
                    if server.lora_runtime is None:
                        return self._send(501, {"error": "LoRA runtime not attached"})
                    action = body.get("action", "")
                    name = body.get("name", "")
                    try:
                        rt = server.lora_runtime
                        if action == "register":
                            rt.register_from_dir(name, body["path"],
                                                 alpha=float(body.get("alpha", 16.0)))
                        elif action == "activate":
                            rt.activate(name, scale=float(body.get("scale", 1.0)))
                        elif action == "deactivate":
                            rt.deactivate(name)
                        elif action == "deactivate_all":
                            rt.deactivate_all()
                        elif action == "scale":
                            rt.set_scale(name, float(body.get("scale", 1.0)))
                        elif action == "unregister":
                            rt.unregister(name)
                        else:
                            return self._send(400, {"error": f"unknown action {action!r}"})
                        return self._send(200, {"ok": True,
                                                "adapters": rt.list_adapters()})
                    except KeyError as e:
                        # runtime KeyErrors carry a message ("unknown adapter:
                        # x"); bare field names come from body[...] access
                        msg = e.args[0] if e.args else str(e)
                        if isinstance(msg, str) and " " in msg:
                            return self._send(400, {"error": msg})
                        return self._send(400, {"error": f"missing field {e}"})
                    except Exception as e:  # noqa: BLE001 — adapter errors to client
                        return self._send(500, {"error": str(e)})
                if self.path == "/v1/training/start":
                    if server.training_manager is None:
                        return self._send(501, {"error": "training not attached"})
                    out = server.training_manager.start(body)
                    return self._send(409 if "error" in out else 200, out)
                if self.path == "/v1/training/stop":
                    if server.training_manager is None:
                        return self._send(501, {"error": "training not attached"})
                    return self._send(200, server.training_manager.stop())
                if self.path == "/v1/dataset/scan":
                    if server.dataset_manager is None:
                        return self._send(501, {"error": "dataset builder not attached"})
                    try:
                        return self._send(200, server.dataset_manager.scan(body))
                    except FileNotFoundError as e:
                        return self._send(400, {"error": f"no such directory: {e}"})
                if self.path == "/v1/dataset/build":
                    if server.dataset_manager is None:
                        return self._send(501, {"error": "dataset builder not attached"})
                    out = server.dataset_manager.start_build(body)
                    return self._send(409 if "error" in out else 200, out)
                return self._send(404, {"error": "not found"})

        return Handler

    # -- lifecycle ---------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        for target in (self._worker, self._cleaner, self._httpd.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self._httpd.server_address[1]

    def stop(self):
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
