"""Training loop: LoRA, LoKr or full flow-matching fine-tunes with checkpoints,
resume and export.  Port of the JAX package's training/trainer.py.

A checkpoint is ``<out_dir>/ckpt_{step:07d}/state.{safetensors,json}`` (the
trainable tree and the optimizer's ``count``, ``mu`` and ``nu``, written with
``loader.save_params``) plus ``ckpt_{step:07d}.meta.json`` (``step`` and the
last 100 losses): the JAX trainer's names, without orbax.  Tensors come back
bit for bit.  As in the JAX trainer, the draws' generator is not saved: a
resumed run draws from its seed again.

The export is ``loader.save_params(<out_dir>/<name>, trainable)``, which the
JAX package's ``loader.load_params`` reads too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from acestep_tpu_torch import loader
from acestep_tpu_torch.config import DiTConfig
from acestep_tpu_torch.pipeline import resolve_device
from acestep_tpu_torch.training.flow_matching import (
    AdamWState, draw, make_optimizer, make_train_step)
from acestep_tpu_torch.training.lokr import apply_lokr, init_lokr, make_lokr_train_step
from acestep_tpu_torch.training.lora import apply_lora, init_lora, make_lora_train_step
from acestep_tpu_torch.weights import flatten, tree_to, tree_unflatten

MODES = ("lora", "lokr", "full")


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    lora_rank: int = 16
    lora_alpha: float = 16.0
    lokr_factor: int = 8                # kron factorization target (mode=lokr)
    mode: str = "lora"                  # lora | lokr | full
    shift: float = 3.0
    checkpoint_every: int = 200
    log_every: int = 10


class Trainer:
    """Drives training over a batch iterator on ``device`` (the card unless
    the caller asks for the CPU); owns the trainable tree, the optimizer state
    and the draws' generator (seeded ``seed + 1``; the adapter's init draws
    from ``seed``)."""

    def __init__(self, base_params: Any, cfg: DiTConfig, train_cfg: TrainConfig, out_dir: str,
                 seed: int = 0, device=None):
        if train_cfg.mode not in MODES:
            raise ValueError(f"mode={train_cfg.mode!r}: expected lora|lokr|full")
        self.device = resolve_device(device)
        self.base_params = tree_to(base_params, self.device)
        self.cfg = cfg
        self.tc = train_cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.opt = make_optimizer(lr=train_cfg.lr, weight_decay=train_cfg.weight_decay,
                                  warmup_steps=train_cfg.warmup_steps,
                                  total_steps=train_cfg.total_steps,
                                  clip_norm=train_cfg.clip_norm)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        if train_cfg.mode == "lora":
            self.trainable = init_lora(init_gen, self.base_params, rank=train_cfg.lora_rank)
            self.step_fn = make_lora_train_step(self.base_params, cfg, self.opt,
                                                alpha=train_cfg.lora_alpha)
        elif train_cfg.mode == "lokr":
            self.trainable = init_lokr(init_gen, self.base_params,
                                       factor=train_cfg.lokr_factor)
            self.step_fn = make_lokr_train_step(self.base_params, cfg, self.opt,
                                                alpha=train_cfg.lora_alpha)
        else:
            # the tree itself is trained: no base is kept beside it, so the
            # first step's new tensors free the drawn ones
            self.trainable, self.base_params = self.base_params, None
            self.step_fn = make_train_step(cfg, self.opt)
        self.opt_state = self.opt.init(self.trainable)
        self.step = 0
        self.history: list = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # -- checkpointing -------------------------------------------------------

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.out_dir, f"ckpt_{step:07d}")

    def _state_tree(self) -> Dict[str, Any]:
        return {"trainable": self.trainable,
                "opt_state": {"count": torch.tensor(self.opt_state.count, dtype=torch.int64),
                              "mu": self.opt_state.mu, "nu": self.opt_state.nu}}

    def save_checkpoint(self) -> str:
        """Write the state at ``self.step`` (again, if it exists)."""
        path = os.path.abspath(self._ckpt_dir(self.step))
        os.makedirs(path, exist_ok=True)
        loader.save_params(os.path.join(path, "state"), self._state_tree())
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": self.step, "history": self.history[-100:]}, f)
        return path

    def resume(self, step: Optional[int] = None) -> bool:
        """Load the checkpoint at ``step`` (the newest when None); False when
        there is none."""
        if step is None:
            ckpts = sorted(d for d in os.listdir(self.out_dir)
                           if d.startswith("ckpt_") and not d.endswith(".meta.json"))
            if not ckpts:
                return False
            step = int(ckpts[-1].split("_")[1])
        path = os.path.abspath(self._ckpt_dir(step))
        saved = flatten(loader.load_params(os.path.join(path, "state"), device=self.device))
        like = self._state_tree()
        names = [n for n, leaf in flatten(like).items() if leaf is not None]
        if sorted(names) != sorted(saved):
            raise ValueError(f"checkpoint {path} does not hold this trainer's state")
        restored = tree_unflatten(like, [saved[n] for n in names])
        self.trainable = restored["trainable"]
        opt = restored["opt_state"]
        self.opt_state = AdamWState(int(opt["count"]), opt["mu"], opt["nu"])
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self.step = meta["step"]
            self.history = meta.get("history", [])
        else:
            self.step = step
        return True

    def export(self, name: str = "adapter") -> str:
        """The trained tree (adapter or full params) as ``loader.save_params``
        files at ``<out_dir>/<name>``."""
        path = os.path.join(self.out_dir, name)
        loader.save_params(path, self.trainable)
        return path

    def merged_params(self) -> Any:
        if self.tc.mode == "lora":
            return apply_lora(self.base_params, self.trainable, self.tc.lora_alpha)
        if self.tc.mode == "lokr":
            return apply_lokr(self.base_params, self.trainable, self.tc.lora_alpha)
        return self.trainable

    # -- loop ----------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor]) -> float:
        """One step on ``batch`` with the next draws; returns the loss."""
        t, noise = draw(self.gen, batch["latents"], self.tc.shift)
        self.trainable, self.opt_state, loss = self.step_fn(
            self.trainable, self.opt_state, batch, t, noise)
        self.step += 1
        loss_f = float(loss)
        self.history.append(loss_f)
        return loss_f

    def train(self, batches: Iterator[Dict[str, Any]], max_steps: Optional[int] = None,
              log_fn: Callable[[str], None] = print,
              metrics: Optional["MetricsLogger"] = None) -> Dict[str, Any]:
        max_steps = max_steps or self.tc.total_steps
        t0 = time.perf_counter()
        for batch in batches:
            if self.step >= max_steps:
                break
            batch = {k: v.to(self.device) for k, v in batch.items()}
            loss_f = self.train_step(batch)
            if metrics is not None:
                metrics.scalar("train/loss", loss_f, self.step)
            if self.step % self.tc.log_every == 0:
                rate = self.step / (time.perf_counter() - t0)
                log_fn(f"step {self.step}: loss {loss_f:.5f} ({rate:.2f} it/s)")
                if metrics is not None:
                    metrics.scalar("train/it_per_s", rate, self.step)
            if self.tc.checkpoint_every and self.step % self.tc.checkpoint_every == 0:
                self.save_checkpoint()
        if metrics is not None:
            metrics.flush()
        return {"steps": self.step,
                "final_loss": self.history[-1] if self.history else None}


class MetricsLogger:
    """JSONL scalar log: one ``{"step", "tag", "value", "wall"}`` event a line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self.path = path
        self._buf: list = []

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._buf.append({"step": int(step), "tag": tag, "value": float(value),
                          "wall": time.time()})
        if len(self._buf) >= 64:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        with open(self.path, "a") as f:
            for ev in self._buf:
                f.write(json.dumps(ev) + "\n")
        self._buf.clear()
