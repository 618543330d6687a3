"""Server-side dataset builder: port of the JAX package's
serving/dataset_manager.py (scan -> label -> preprocess over REST).

  scan  - a directory's audio, sidecars and csv metadata (synchronous);
  build - a background thread: optional LM labeling, then VAE / condition
          preprocessing into ``<out_dir>/sample_XXXXX.safetensors`` and
          ``manifest.json`` (the layout training.data.PreprocessedDataset reads).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from acestep_tpu_torch.training.data import build_dataset
from acestep_tpu_torch.training.dataset_builder import label_all, read_audio, scan_directory


class DatasetManager:
    """One build at a time (the engine is a shared serial resource, as in
    TrainingManager)."""

    def __init__(self, engine, lm=None, codec_params=None, tokenizer=None):
        self.engine = engine
        self.lm = lm
        self.codec_params = codec_params
        self.tokenizer = tokenizer
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._status: Dict[str, Any] = {"state": "idle"}

    def scan(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        directory = payload.get("directory", "")
        samples = scan_directory(directory)
        return {
            "directory": directory,
            "count": len(samples),
            "samples": [{k: v for k, v in dataclasses.asdict(s).items()
                         if k != "audio_path" or payload.get("include_paths")}
                        for s in samples[: int(payload.get("limit", 200))]],
        }

    def start_build(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return {"error": "a dataset build is already running"}
            directory = payload.get("directory", "")
            out_dir = payload.get("output_dir", "")
            if not directory or not out_dir:
                return {"error": "directory and output_dir are required"}
            self._status = {"state": "starting", "directory": directory, "output_dir": out_dir,
                            "message": "", "done": 0, "total": 0, "started_at": time.time()}
            self._thread = threading.Thread(target=self._run, args=(payload,), daemon=True)
            self._thread.start()
            return {"state": "starting"}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._status)

    def _progress(self, msg: str, done: Optional[int] = None,
                  total: Optional[int] = None) -> None:
        with self._lock:
            self._status["message"] = msg
            if done is not None:
                self._status["done"] = done
            if total is not None:
                self._status["total"] = total

    def _tokenize(self, text: str, cap: int):
        if not text:
            return None
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(text)[:cap]
            return np.asarray([ids], np.int32) if ids else None
        return np.asarray([[b % 32000 for b in text.encode()][:cap]], np.int32)

    def _run(self, payload: Dict[str, Any]) -> None:
        try:
            directory, out_dir = payload["directory"], payload["output_dir"]
            with self._lock:
                self._status["state"] = "scanning"
            samples = scan_directory(directory)
            self._progress(f"scanned {len(samples)} samples", done=0, total=len(samples))
            if payload.get("auto_label", True) and self.lm is not None:
                with self._lock:
                    self._status["state"] = "labeling"
                samples = label_all(samples, self.engine, self.lm, self.codec_params,
                                    progress_callback=self._progress)
            with self._lock:
                self._status["state"] = "preprocessing"
            raw = []
            for i, s in enumerate(samples):
                self._progress(f"loading {s.filename}", done=i)
                audio, _sr = read_audio(s.audio_path)
                raw.append({"audio": audio,
                            "style_token_ids": self._tokenize(s.caption or s.filename, 256),
                            "lyric_token_ids": self._tokenize(s.lyrics, 2048)})
            build_dataset(self.engine, raw, out_dir)
            with self._lock:
                self._status.update(
                    state="completed", done=len(samples),
                    message=f"wrote {len(samples)} samples to {out_dir}", output_dir=out_dir,
                    elapsed_s=round(time.time() - self._status["started_at"], 1))
        except Exception as e:  # noqa: BLE001 - surfaced through /v1/dataset/status
            with self._lock:
                self._status.update(state="failed", error=f"{type(e).__name__}: {e}")
