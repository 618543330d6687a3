"""Background training jobs for the REST server: port of the JAX package's
serving/training_manager.py.

One job at a time runs in a daemon thread while the server answers status
polls; a job stops cooperatively and resumes from the trainer's own
checkpoints.  A ``trainer_factory(payload) -> (trainer, batches)`` builds the
job; the default one reads a dataset directory (training/data.py) and a
converted DiT checkpoint and builds a :class:`Trainer` on the manager's
device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.pipeline import resolve_device
from acestep_tpu_torch.training.data import PreprocessedDataset
from acestep_tpu_torch.training.trainer import TrainConfig, Trainer


def default_trainer_factory(payload: Dict[str, Any], device=None):
    """A Trainer and its batch iterator from a REST payload.

    Keys: ``dataset_dir`` (a build_dataset directory), ``checkpoint_dir`` (a
    directory with ``dit.safetensors`` / ``dit.json`` as ``loader.save_params``
    writes them and a ``config.json`` of the DiT, or the ``dit`` path itself),
    ``output_dir``; optional lr, total_steps, warmup_steps, batch_size, mode
    (lora | lokr | full), lora_rank, lora_alpha, lokr_factor, shift, seed,
    checkpoint_every, resume, dit_config."""
    dev = resolve_device(device)
    ckpt_dir = payload["checkpoint_dir"]
    params = loader.load_params(os.path.join(ckpt_dir, "dit") if os.path.isdir(ckpt_dir)
                                else ckpt_dir, device=dev)
    cfg_dict = payload.get("dit_config")
    if cfg_dict is None and os.path.isdir(ckpt_dir):
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg_dict = json.load(f)
    cfg = DiTConfig.from_dict(cfg_dict) if cfg_dict else DiTConfig()
    total_steps = int(payload.get("total_steps", 1000))
    # a short job gets a proportional warmup that leaves the cosine room
    warmup = int(payload.get("warmup_steps", min(100, max(1, total_steps // 10))))
    warmup = min(warmup, max(0, total_steps - 1))
    tc = TrainConfig(
        lr=float(payload.get("lr", 1e-4)),
        warmup_steps=warmup,
        total_steps=total_steps,
        mode=str(payload.get("mode", "lora")),
        lora_rank=int(payload.get("lora_rank", 16)),
        lora_alpha=float(payload.get("lora_alpha", 16.0)),
        lokr_factor=int(payload.get("lokr_factor", 8)),
        shift=float(payload.get("shift", 3.0)),
        checkpoint_every=int(payload.get("checkpoint_every", 200)),
    )
    trainer = Trainer(params, cfg, tc, payload["output_dir"], seed=int(payload.get("seed", 0)),
                      device=dev)
    if payload.get("resume"):
        trainer.resume()
    ds = PreprocessedDataset(payload["dataset_dir"], device=dev)
    batches = ds.batches(batch_size=int(payload.get("batch_size", 1)),
                         seed=int(payload.get("seed", 0)))        # cycles forever
    return trainer, batches


class TrainingManager:
    """One-at-a-time background training with a pollable status."""

    def __init__(self, trainer_factory: Optional[Callable[..., Tuple[Any, Any]]] = None,
                 device=None):
        self._factory = trainer_factory or functools.partial(default_trainer_factory,
                                                             device=device)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._trainer = None
        self._state: Dict[str, Any] = {"state": "idle"}

    # -- control -------------------------------------------------------------

    def start(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return {"error": "a training job is already running"}
            self._stop.clear()
            self._trainer = None
            self._state = {
                "state": "starting", "step": 0, "loss": None, "started_at": time.time(),
                "payload_summary": {k: payload.get(k) for k in
                                    ("dataset_dir", "output_dir", "mode", "total_steps", "lr")
                                    if k in payload},
            }
            self._thread = threading.Thread(target=self._run, args=(dict(payload),),
                                            daemon=True)
            self._thread.start()
        return {"state": "starting"}

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        return {"state": "stopping"}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            st = dict(self._state)
        tr = self._trainer
        if tr is not None and tr.history:
            st["loss"] = tr.history[-1]
            st["loss_history_tail"] = [round(x, 5) for x in tr.history[-100:]]
        if tr is not None and st.get("state") == "running":
            st["step"] = tr.step
            started = st.get("started_at")
            if started and tr.step:
                rate = tr.step / max(time.time() - started, 1e-6)
                st["it_per_s"] = round(rate, 3)
                total = st.get("total_steps") or 0
                if total > tr.step and rate > 0:
                    st["eta_s"] = round((total - tr.step) / rate, 1)
        return st

    # -- worker --------------------------------------------------------------

    def _guarded_batches(self, batches):
        for b in batches:
            if self._stop.is_set():
                return
            yield b

    def _run(self, payload: Dict[str, Any]) -> None:
        try:
            trainer, batches = self._factory(payload)
            self._trainer = trainer
            total = getattr(getattr(trainer, "tc", None), "total_steps", None)
            max_steps = int(payload.get("max_steps") or total or 1000)
            with self._lock:
                self._state.update(state="running", total_steps=max_steps)
            summary = trainer.train(self._guarded_batches(batches), max_steps=max_steps,
                                    log_fn=lambda _m: None)
            export_path = None
            if hasattr(trainer, "export"):
                export_path = trainer.export(payload.get("export_name", "adapter"))
            final = "stopped" if self._stop.is_set() else "completed"
            with self._lock:
                self._state.update(state=final, step=trainer.step,
                                   loss=trainer.history[-1] if trainer.history else None,
                                   summary=summary, export_path=export_path,
                                   finished_at=time.time())
        except Exception as e:  # noqa: BLE001 - a job's error goes to the poller
            with self._lock:
                self._state.update(state="failed", error=f"{type(e).__name__}: {e}",
                                   finished_at=time.time())
