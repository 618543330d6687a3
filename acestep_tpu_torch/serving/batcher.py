"""Continuous batcher for song requests: the port's copy of the JAX package's
serving/batcher.py (configs[3]: batch 8, mixed 10-600 s requests).

Requests queue by their merge key (task and schedule); when ``max_batch``
items wait or the oldest has waited ``max_wait_s``, the highest-priority
request anchors a batch and others join while the batch's frame-bucket spread
stays within ``pad_ratio`` and its size within the memory plan's cap at its
largest bucket (``max_batch_for``, e.g. ``AceStepEngine.max_batch_for_frames``).
Shorter items pad up to the batch's bucket; per-item durations carry their
validity.  Queued priority rises one level per ``AGING_S`` so nothing starves.
One worker thread runs the merged batches one at a time.

The merge key holds every field that changes the computed function: task,
schedule, sampler, the CFG fields, cover strength, repaint span and track.
Reference latents merge with their clip masks (a request without them gets
masked-out clips), source latents zero-padded to the longest.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from acestep_tpu_torch.pipeline import (
    GenerationRequest,
    GenerationResult,
    _token_bucket,
    bucket_frames,
    frames_for_duration,
)

AGING_S = 5.0                # queued priority rises one level per AGING_S
MERGED_SIZES_WINDOW = 256    # rolling window of merged batch sizes
ADMIT_CACHE_TTL_S = 60.0     # re-query the admission hook after this long

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _Pending:
    req: GenerationRequest
    future: Future
    arrived: float
    priority: int = 0        # higher runs first


def _merge_key(req: GenerationRequest) -> Tuple:
    """Fields that must be equal for a merge: everything merge_requests takes
    from the first request that changes the computed function.  Frame and
    token buckets are not in it: shorter requests pad up."""
    return (req.task, req.shift, tuple(req.timesteps) if req.timesteps else None,
            req.infer_method, req.infer_steps, req.guidance_scale, req.use_adg,
            req.cfg_interval_start, req.cfg_interval_end, req.audio_cover_strength,
            req.repaint_start_s, req.repaint_end_s, req.track_name,
            tuple(req.complete_track_classes) if req.complete_track_classes else None)


def _req_frames(req: GenerationRequest) -> int:
    return bucket_frames(frames_for_duration(req.duration_s))


def _shape_key(req: GenerationRequest) -> Tuple:
    """Merge key plus frame and token buckets and the reference clip count:
    requests sharing it merge with no padding."""
    style_b = _token_bucket(req.style_token_ids.shape[1]) if req.style_token_ids is not None else 0
    lyric_b = _token_bucket(req.lyric_token_ids.shape[1]) if req.lyric_token_ids is not None else 0
    timbre = req.refer_latents.shape[1] if req.refer_latents is not None else 0
    return _merge_key(req) + (_req_frames(req), style_b, lyric_b, timbre)


def _pad_ids(ids: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    mask = np.ones_like(ids)
    pad = bucket - ids.shape[1]
    if pad > 0:
        ids = np.pad(ids, ((0, 0), (0, pad)))
        mask = np.pad(mask, ((0, 0), (0, pad)))
    return ids, mask


def merge_requests(reqs: List[GenerationRequest]) -> GenerationRequest:
    """Merge compatible requests into one batched request: durations and seeds
    per item, token ids padded to the widest bucket (a request without a
    branch gets a masked-out row), reference latents padded to the most clips
    and frames with a clip mask of each request's clips, source latents
    zero-padded to the longest (batcher.py:53-175)."""
    if not reqs:
        raise ValueError("nothing to merge")
    key = _merge_key(reqs[0])
    if any(_merge_key(r) != key for r in reqs):
        raise ValueError("incompatible merge")
    out = dataclasses.replace(reqs[0])
    out.batch_size = sum(r.batch_size for r in reqs)
    out.durations_s = [
        d for r in reqs
        for d in (r.durations_s if r.durations_s else [r.duration_s] * r.batch_size)]
    out.duration_s = max(out.durations_s)
    out.seeds = [s for r in reqs
                 for s in (list(r.seeds) if r.seeds else list(range(r.batch_size)))]

    def cat(field):
        vals = [getattr(r, field) for r in reqs]
        if all(v is None for v in vals):
            return None, None
        width = _token_bucket(max(v.shape[1] for v in vals if v is not None))
        arrs, masks = [], []
        for r, v in zip(reqs, vals):
            b = r.batch_size
            if v is None:
                arrs.append(np.zeros((b, width), np.int32))
                masks.append(np.zeros((b, width), np.int32))
            else:
                ids, m = _pad_ids(np.asarray(v, np.int32), width)
                arrs.append(np.broadcast_to(ids, (b, width)) if ids.shape[0] == 1 else ids)
                masks.append(np.broadcast_to(m, (b, width)) if m.shape[0] == 1 else m)
        return np.concatenate(arrs, 0), np.concatenate(masks, 0)

    out.style_token_ids, out.style_mask = cat("style_token_ids")
    out.lyric_token_ids, out.lyric_mask = cat("lyric_token_ids")

    def rows(r, v):
        return np.broadcast_to(v, (r.batch_size,) + v.shape[1:]) if v.shape[0] == 1 else v

    refers = [r.refer_latents for r in reqs if r.refer_latents is not None]
    if refers:
        n_refer = max(v.shape[1] for v in refers)
        lr = max(v.shape[2] for v in refers)
        blocks, cmasks = [], []
        for r in reqs:
            cm = np.zeros((r.batch_size, n_refer), np.int32)
            if r.refer_latents is None:
                blocks.append(np.zeros((r.batch_size, n_refer, lr, refers[0].shape[-1]),
                                       np.float32))
            else:
                v = np.asarray(r.refer_latents, np.float32)
                blocks.append(rows(r, np.pad(v, ((0, 0), (0, n_refer - v.shape[1]),
                                                 (0, lr - v.shape[2]), (0, 0)))))
                cm[:, :v.shape[1]] = 1
            cmasks.append(cm)
        out.refer_latents = np.concatenate(blocks, 0)
        out.refer_mask = np.concatenate(cmasks, 0)
    srcs = [r.src_latents for r in reqs if r.src_latents is not None]
    if srcs:
        t_frames = max(v.shape[1] for v in srcs)
        blocks = []
        for r in reqs:
            if r.src_latents is None:
                blocks.append(np.zeros((r.batch_size, t_frames, srcs[0].shape[-1]), np.float32))
            else:
                v = np.asarray(r.src_latents, np.float32)
                blocks.append(rows(r, np.pad(v, ((0, 0), (0, t_frames - v.shape[1]), (0, 0)))))
        out.src_latents = np.concatenate(blocks, 0)
    return out


def split_result(result: GenerationResult, sizes: List[int]) -> List[GenerationResult]:
    """One result per merged request, slicing the int16 payload; a single
    request passes through with its segments."""
    if len(sizes) == 1:
        return [result]
    outs = []
    i = 0
    for n in sizes:
        sl = slice(i, i + n)
        outs.append(GenerationResult(
            latents=result.latents[sl], sample_rate=result.sample_rate,
            time_costs=result.time_costs, seeds=result.seeds[sl],
            audio_lengths=result.audio_lengths[sl], audio_scale=result.audio_scale,
            audio_i16=result.audio_i16[sl]))
        i += n
    return outs


class ContinuousBatcher:
    """Merges queued requests and runs them through ``run_fn`` on one worker
    thread; ``submit`` returns a future of the request's own result."""

    def __init__(self, run_fn: Callable[[GenerationRequest], GenerationResult],
                 max_batch: int = 8, max_wait_s: float = 0.25, pad_ratio: float = 2.5,
                 max_batch_for: Optional[Callable[[int], int]] = None):
        self.run_fn = run_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        # largest frame-bucket spread inside one merged batch (1.0: exact buckets)
        self.pad_ratio = max(1.0, pad_ratio)
        self.max_batch_for = max_batch_for
        self._admit_cache: Dict[int, Tuple[int, float]] = {}  # frames -> (cap, stamp)
        self._queues: Dict[Tuple, List[_Pending]] = {}
        self._lock = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.stats = {
            "batches": 0, "requests": 0,
            "merged_sizes": collections.deque(maxlen=MERGED_SIZES_WINDOW),
            "padded_items": 0,
        }

    def stats_summary(self) -> Dict[str, Any]:
        """Merge-rate stats for the REST server's /v1/stats."""
        sizes = list(self.stats["merged_sizes"])  # rolling window, not history
        return {
            "requests": self.stats["requests"],
            "batches": self.stats["batches"],
            "avg_merged_batch": round(sum(sizes) / len(sizes), 2) if sizes else 0.0,
            "max_merged_batch": max(sizes) if sizes else 0,
            "merge_window": MERGED_SIZES_WINDOW,
            "padded_items": self.stats["padded_items"],
            "queued": sum(len(q) for q in self._queues.values()),
        }

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=5)

    def submit(self, req: GenerationRequest, priority: int = 0) -> Future:
        fut: Future = Future()
        p = _Pending(req, fut, time.time(), priority)
        with self._lock:
            self._queues.setdefault(_merge_key(req), []).append(p)
            self.stats["requests"] += 1
            self._lock.notify_all()
        return fut

    @staticmethod
    def _effective_priority(p: _Pending, now: float) -> float:
        return p.priority + (now - p.arrived) / AGING_S

    def _allowed_batch(self, frames: int) -> int:
        """Admission cap at a frame bucket, memoized for ADMIT_CACHE_TTL_S."""
        if self.max_batch_for is None:
            return self.max_batch
        now = time.time()
        cached = self._admit_cache.get(frames)
        if cached is None or now - cached[1] > ADMIT_CACHE_TTL_S:
            try:
                cap = int(self.max_batch_for(frames))
            except Exception:
                # fail closed: a broken admission hook serializes
                log.warning("max_batch_for(%d) raised; failing closed to cap=1",
                            frames, exc_info=True)
                cap = 1
            self._admit_cache[frames] = (max(1, min(self.max_batch, cap)), now)
        return self._admit_cache[frames][0]

    def _pick_batch(self) -> Optional[List[_Pending]]:
        now = time.time()
        # highest effective priority (priority + age credit) first
        ordered = sorted(
            (kq for kq in self._queues.items() if kq[1]),
            key=lambda kq: -max(self._effective_priority(p, now) for p in kq[1]))
        for _key, q in ordered:
            q.sort(key=lambda p: (-self._effective_priority(p, now), p.arrived))
            total = sum(p.req.batch_size for p in q)
            age = now - min(p.arrived for p in q)
            if total >= self.max_batch or age >= self.max_wait_s:
                # greedy pad-up from the highest-priority anchor: an item joins
                # while the bucket spread stays within pad_ratio and the batch
                # within the cap at its largest bucket
                take, n = [], 0
                fmin = fmax = _req_frames(q[0].req)
                i = 0
                while i < len(q):
                    p = q[i]
                    f = _req_frames(p.req)
                    nf_min, nf_max = min(fmin, f), max(fmax, f)
                    if (n + p.req.batch_size <= self._allowed_batch(nf_max)
                            and nf_max <= nf_min * self.pad_ratio):
                        take.append(q.pop(i))
                        n += p.req.batch_size
                        fmin, fmax = nf_min, nf_max
                    else:
                        i += 1
                if not take:       # a single over-size request runs alone
                    take = [q.pop(0)]
                if len(take) > 1:
                    self.stats["padded_items"] += sum(
                        1 for p in take if _req_frames(p.req) < fmax)
                return take
        return None

    def _loop(self):
        while True:
            with self._lock:
                batch = self._pick_batch()
                while batch is None and not self._stop:
                    self._lock.wait(timeout=self.max_wait_s / 2)
                    batch = self._pick_batch()
                if self._stop and batch is None:
                    return
            try:
                merged = merge_requests([p.req for p in batch])
                result = self.run_fn(merged)
                if len(batch) > 1 and result.latents.shape[0] != merged.batch_size:
                    # the engine clamped the merged batch: fail loudly rather
                    # than hand the surviving rows to the wrong futures
                    raise RuntimeError(
                        f"engine returned {result.latents.shape[0]} items for a "
                        f"merged batch of {merged.batch_size}; configure the "
                        f"batcher's max_batch_for to respect the memory plan")
                parts = split_result(result, [p.req.batch_size for p in batch])
                for p, r in zip(batch, parts):
                    p.future.set_result(r)
                self.stats["batches"] += 1
                self.stats["merged_sizes"].append(merged.batch_size)
            except Exception as e:  # noqa: BLE001 - every future must hear of it
                log.warning("merged batch failed", exc_info=True)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
