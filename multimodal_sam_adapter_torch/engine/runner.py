"""Epoch-based training runner: the train loop, the eval hook, early
stopping, checkpoints and logging. The counterpart of
multimodal_sam_adapter_tpu/engine/runner.py (itself the reference's mmcv
EpochBasedRunner and hooks).

The hot path is the train step (engine/train.py) on each batch, which the
runner moves to the model's device (pinned host memory, non_blocking);
the loss is read back (`.item()`, a device sync) only at log intervals.
Named spans `msa.data`, `msa.checkpoint` and `msa.eval` mark the phases
in a torch.profiler trace (utils/profiling.py:annotate), beside the
step's own `msa.train_step` (engine/train.py).

On data-parallel ranks (parallel/ddp.py) every rank runs the loop on its
shard of the loader; rank 0 alone writes checkpoints, `best.pth` and the
log, the others wait for it at a barrier; the logged loss is the mean
over the ranks (all-reduced at log intervals only); every rank evaluates
its shard and the evaluator sums the histograms over the ranks, so every
rank takes the same best-checkpoint and early-stopping decisions; every
rank resumes from the same file.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..parallel.ddp import (all_reduce_sum, average_partial_grads, barrier,
                            is_main, rank_world)
from ..utils.profiling import annotate
from .checkpoint import (latest_checkpoint, load_state_dict_file,
                         restore_checkpoint, save_checkpoint)
from .train import TrainState


class EarlyStopping:
    """Stop when `monitor` has not improved for `patience` evaluations
    (the reference's mmcv_custom/early_stopping.py)."""

    def __init__(self, monitor: str = "mIoU", rule: str = "greater",
                 patience: int = 10, min_delta: float = 0.0):
        self.monitor = monitor
        self.rule = rule
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.wait = 0

    def update(self, metrics: Dict[str, float]) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        improved = (
            self.best is None
            or (self.rule == "greater" and value > self.best + self.min_delta)
            or (self.rule == "less" and value < self.best - self.min_delta))
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
        return self.wait >= self.patience


class TrainLogger:
    """Loss / throughput to stdout and `<work_dir>/train_log.jsonl`, and to
    TensorBoard when `torch.utils.tensorboard` imports; on rank 0 only.
    Every rank calls `log_step`: the logged values are means over the
    ranks."""

    def __init__(self, work_dir: str, interval: int = 50,
                 tensorboard: bool = True):
        self.interval = interval
        self.main = is_main()
        self.jsonl = self.tb = None
        if self.main:
            os.makedirs(work_dir, exist_ok=True)
            self.jsonl = open(osp.join(work_dir, "train_log.jsonl"), "a")
        if tensorboard and self.main:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(osp.join(work_dir, "tb"))
            except Exception:
                self.tb = None
        self._t0 = time.time()
        self._count = 0

    def log_step(self, step: int, epoch: int, metrics: Dict) -> None:
        """`metrics` may hold device tensors: they are read (a device sync)
        only on the steps that are logged (every `interval`-th and the
        first)."""
        self._count += 1
        if step % self.interval != 0 and step != 1:
            return
        world = rank_world()[1]
        if world > 1:    # a collective: every rank logs the same steps
            metrics = {k: all_reduce_sum(torch.as_tensor(v)) / world
                       for k, v in metrics.items()}
        dt = time.time() - self._t0
        rec = {"step": step, "epoch": epoch,
               "iters_per_s": round(self._count / max(dt, 1e-9), 3),
               **{k: float(v) for k, v in metrics.items()}}
        self._write(rec)
        if self.tb:
            for k, v in rec.items():
                if k not in ("step", "epoch"):
                    self.tb.add_scalar(k, v, step)
        self._t0 = time.time()
        self._count = 0

    def log_eval(self, epoch: int, summary: Dict[str, float]) -> None:
        self._write({"epoch": epoch,
                     "eval": {k: float(v) for k, v in summary.items()}})
        if self.tb:
            for k, v in summary.items():
                self.tb.add_scalar(f"val/{k}", float(v), epoch)

    def _write(self, rec: Dict) -> None:
        if not self.main:
            return
        print(json.dumps(rec), flush=True)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        if self.jsonl:
            self.jsonl.close()
        if self.tb:
            self.tb.close()


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch's `img` (float32) and `gt` (int64) on `device`, copied
    from pinned host memory without blocking when it is a card."""
    out = {}
    for k, dtype in (("img", torch.float32), ("gt", torch.int64)):
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True).to(dtype)
    return out


class EpochRunner:
    """Runs `train_step(state, batch)` over `train_loader` for epochs
    `start_epoch` .. `max_epochs - 1`; after each `ckpt_interval`-th epoch
    a checkpoint of the model and optimizer (`<work_dir>/ckpts/
    step_<N>.pth`, the newest `max_keep_ckpts` kept), after each
    `eval_interval`-th `eval_fn(state)` -> summary, logged, a `best.pth`
    when its `save_best` metric improves, and early stopping. `state.step`
    counts micro-batches, as the JAX state's step does."""

    def __init__(self, state: TrainState, train_step: Callable,
                 train_loader, work_dir: str, max_epochs: int = 100,
                 eval_fn: Optional[Callable] = None, eval_interval: int = 1,
                 save_best: Optional[str] = "mIoU", ckpt_interval: int = 1,
                 max_keep_ckpts: int = 1,
                 early_stopping: Optional[EarlyStopping] = None,
                 log_interval: int = 50, ckpt_meta: Optional[Dict] = None):
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.work_dir = work_dir
        self.max_epochs = max_epochs
        self.eval_fn = eval_fn
        self.eval_interval = eval_interval
        self.save_best = save_best
        self.ckpt_interval = ckpt_interval
        self.max_keep_ckpts = max_keep_ckpts
        self.early_stopping = early_stopping
        self.logger = TrainLogger(work_dir, log_interval)
        self.ckpt_meta = ckpt_meta or {}
        self.device = next(state.model.parameters()).device
        self.start_epoch = 0
        self.best_metric = -np.inf
        self.stop_training = False

    @property
    def ckpt_dir(self) -> str:
        return osp.join(self.work_dir, "ckpts")

    def resume(self, path: Optional[str] = None, auto: bool = False
               ) -> Optional[str]:
        """Restore model, optimizer (moments, counts, an accumulation's
        gradients) and step from `path`, or with `auto` from the newest
        step file in the work dir's ckpts/ (nothing there: a fresh start).
        Training goes on at epoch step // steps_per_epoch."""
        if path is None and auto:
            path = latest_checkpoint(self.ckpt_dir)
        if path is None:
            return None
        payload = restore_checkpoint(path, self.device)
        self.state.model.load_state_dict(payload["state_dict"], strict=True)
        self.state.optimizer.load_state_dict(payload["optimizer"])
        self.state.step = int(payload["meta"]["step"])
        self.start_epoch = self.state.step // max(len(self.train_loader), 1)
        self.best_metric = payload["meta"].get("best_metric", -np.inf)
        if is_main():
            print(f"resumed from {path} at step {self.state.step}",
                  flush=True)
        return path

    def load_weights(self, path: str) -> None:
        """The model's weights and BatchNorm statistics from `path` (any
        form `load_state_dict_file` reads), strictly; the optimizer and the
        step stay fresh."""
        self.state.model.load_state_dict(
            load_state_dict_file(path, self.device), strict=True)

    def _save(self, epoch: int, tag: Optional[str] = None) -> str:
        """Every rank averages an accumulation's partial gradients (a
        collective), rank 0 writes, every rank waits for it. Returns the
        path (on every rank)."""
        meta = dict(self.ckpt_meta, epoch=epoch, iter=self.state.step,
                    best_metric=float(self.best_metric))
        with annotate("msa.checkpoint"):
            average_partial_grads(self.state.optimizer)
            path = osp.join(self.ckpt_dir,
                            f"{tag or f'step_{self.state.step}'}.pth")
            if is_main():
                path = save_checkpoint(
                    self.ckpt_dir, self.state.model, self.state.optimizer,
                    self.state.step, meta,
                    self.max_keep_ckpts if tag is None else 0, tag=tag)
            barrier()
            return path

    def run(self) -> TrainState:
        for epoch in range(self.start_epoch, self.max_epochs):
            self.train_loader.set_epoch(epoch)
            batches = iter(self.train_loader)
            while True:
                with annotate("msa.data"):
                    batch = next(batches, None)
                    if batch is None:
                        break
                    batch = to_device(batch, self.device)
                out = self.train_step(self.state, batch)
                self.logger.log_step(self.state.step, epoch,
                                     {"loss": out["loss"]})
                if self.stop_training:
                    break
            if (epoch + 1) % self.ckpt_interval == 0:
                self._save(epoch)
            if self.eval_fn and (epoch + 1) % self.eval_interval == 0:
                with annotate("msa.eval"):
                    summary = self.eval_fn(self.state)
                self.logger.log_eval(epoch, summary)
                val = summary.get(self.save_best or "mIoU", -np.inf)
                if self.save_best and val > self.best_metric:
                    self.best_metric = val
                    self._save(epoch, tag="best")
                if self.early_stopping and self.early_stopping.update(summary):
                    if is_main():
                        print(f"early stopping at epoch {epoch}", flush=True)
                    self.stop_training = True
            if self.stop_training:
                break
        return self.state
