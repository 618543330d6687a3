"""Progress / ETA estimation for generation jobs: port of the JAX package's
progress.py, the same cache file.

Observed wall times are bucketed by (duration bucket, batch size), smoothed
by an EWMA per bucket and kept in a JSON cache (``ACESTEP_TPU_PROGRESS_CACHE``
overrides its path), so a later run can give an ETA before its first job.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

# duration buckets in seconds (short / medium / long / xlong)
BUCKETS = ((0, 30, "short"), (30, 120, "medium"), (120, 300, "long"),
           (300, 10_000, "xlong"))
EWMA_ALPHA = 0.4
DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "acestep_tpu", "progress_eta.json"
)


def duration_bucket(seconds: float) -> str:
    for lo, hi, name in BUCKETS:
        if lo <= seconds < hi:
            return name
    return "xlong"


class ProgressEstimator:
    def __init__(self, cache_path: Optional[str] = None):
        self.cache_path = cache_path or os.environ.get(
            "ACESTEP_TPU_PROGRESS_CACHE", DEFAULT_CACHE
        )
        self._lock = threading.Lock()
        self._table: Dict[str, float] = {}
        self._load()

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.cache_path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                self._table = {str(k): float(v) for k, v in data.items()}
        except (OSError, ValueError):
            self._table = {}

    def _save(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
            with open(self.cache_path, "w") as f:
                json.dump(self._table, f)
        except OSError:
            pass

    # -- api -----------------------------------------------------------------

    @staticmethod
    def _key_from_payload(payload: Dict[str, Any]) -> str:
        dur = float(payload.get("duration") or payload.get("duration_s") or 30.0)
        batch = int(payload.get("batch_size") or 1)
        return f"{duration_bucket(dur)}/b{batch}"

    def estimate(self, payload: Dict[str, Any]) -> Optional[float]:
        """ETA in seconds for a job payload, or None with no history."""
        key = self._key_from_payload(payload)
        with self._lock:
            if key in self._table:
                return self._table[key]
            # fall back to any bucket with the same batch, scaled by duration
            bucket = key.split("/")[0]
            for (lo, hi, name) in BUCKETS:
                alt = key.replace(bucket, name)
                if alt in self._table:
                    return self._table[alt]
        return None

    def observe(self, payload: Dict[str, Any], wall_seconds: float) -> None:
        key = self._key_from_payload(payload)
        with self._lock:
            old = self._table.get(key)
            self._table[key] = (
                wall_seconds if old is None
                else (1 - EWMA_ALPHA) * old + EWMA_ALPHA * wall_seconds
            )
            self._save()
