"""Fault-tolerant training loop on one device.

A port of ``repro.train.trainer``:
  * auto-resume: picks up the latest intact checkpoint, including the
    data stream's state (exact stream position), restored onto the
    trainer's device;
  * atomic checkpoints every N steps with retention;
  * NaN/inf guard: skips a step whose loss is not finite, counts it, and
    aborts past ``nan_limit`` (rollback point = last checkpoint);
  * loss-spike detection (EMA-relative) with optional rollback;
  * straggler watchdog: logs and counts steps slower than
    ``straggler_factor`` x the running median.

The reference's step is functional, and its trainer throws a bad
update away.  This one updates the params and moments in place (a
second copy does not fit beside a full-width model on one card), so it
looks at the loss first: loss and gradients, then the guard, then
clipping and AdamW.  The guard reads only the loss, as in the reference;
a finite loss with non-finite gradients is applied in both.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import time
from pathlib import Path
from typing import Any, Dict, Iterator

import torch

from ..checkpoint import CheckpointManager, restore_on_device
from ..configs.base import ModelConfig, ShapeSpec
from ..kernels.backend import resolve_device
from ..launch import steps
from ..models import lm
from ..optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    workdir: str
    num_steps: int = 100
    save_every: int = 50
    keep_checkpoints: int = 3
    lr: float = 3e-4
    log_every: int = 10
    nan_limit: int = 10
    spike_factor: float = 4.0
    rollback_on_spike: bool = False
    straggler_factor: float = 3.0
    microbatches: int = 1


class Trainer:
    """Trains ``cfg`` on ``data_iter``'s numpy batches on ``device``
    (default the card).  After ``train`` the final state is in
    ``params`` and ``opt_state``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig, data_iter: Iterator,
                 data_state=None, device=None):
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.data = data_iter
        self.data_state = data_state
        self.ckpt = CheckpointManager(Path(tcfg.workdir) / "ckpt",
                                      tcfg.save_every, tcfg.keep_checkpoints)
        self.metrics_path = Path(tcfg.workdir) / "metrics.jsonl"
        self.metrics_path.parent.mkdir(parents=True, exist_ok=True)
        self.nan_steps = 0
        self.straggler_steps = 0
        self._times: list = []
        self.params = self.opt_state = None

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = lm.init_params(self.cfg, gen, device=self.device)
        return params, adamw.adamw_init(params), 0

    def restore_or_init(self, seed: int = 0):
        latest = self.ckpt.latest()
        if latest is None:
            return self.init_state(seed)
        params_like = lm.param_specs(self.cfg)
        opt_like = adamw.adamw_state_specs(params_like)
        (params, opt), extra = restore_on_device(
            latest, (params_like, opt_like), self.device)
        step = extra["step"]
        if self.data_state is not None and "data" in extra:
            self.data_state.seed = extra["data"]["seed"]
            self.data_state.step = extra["data"]["step"]
        print(f"[trainer] resumed from {latest} at step {step}")
        return params, opt, step

    # -- loop --------------------------------------------------------------
    def train(self, seed: int = 0) -> Dict[str, Any]:
        params, opt, step = self.restore_or_init(seed)
        ema_loss = None
        last_good = step
        t_wall = time.time()
        while step < self.tcfg.num_steps:
            batch = steps.to_device(next(self.data), self.device)
            t0 = time.time()
            loss_t, grads = steps.loss_and_grads(params, self.cfg, batch,
                                                 self.tcfg.microbatches)
            loss = float(loss_t)

            if not math.isfinite(loss):
                # poisoned step: no update, keep the old state
                del grads
                self._watchdog(step, time.time() - t0)
                self.nan_steps += 1
                self._log(step, {"loss": loss, "event": "nan_skip"})
                if self.nan_steps > self.tcfg.nan_limit:
                    raise RuntimeError(
                        f"{self.nan_steps} non-finite steps; aborting to "
                        f"last checkpoint at step {last_good}")
                step += 1
                continue

            if (ema_loss is not None and self.tcfg.rollback_on_spike
                    and loss > self.tcfg.spike_factor * ema_loss):
                del grads
                self._log(step, {"loss": loss, "event": "spike_rollback"})
                params = opt = None
                params, opt, step = self.restore_or_init(seed)
                continue

            opt, gnorm = steps.apply_update(params, opt, grads, self.tcfg.lr)
            del grads
            gnorm = float(gnorm)
            if self.device.type == "cuda":      # the update too, not its launch
                torch.cuda.synchronize(self.device)
            dt = time.time() - t0
            self._watchdog(step, dt)
            ema_loss = loss if ema_loss is None else \
                0.95 * ema_loss + 0.05 * loss
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.num_steps:
                self._log(step, {"loss": loss, "ema": ema_loss,
                                 "grad_norm": gnorm, "step_s": dt})
            extra = {"step": step}
            if self.data_state is not None:
                extra["data"] = self.data_state.to_dict()
            if self.ckpt.maybe_save(step, (params, opt), extra):
                last_good = step
        self.params, self.opt_state = params, opt
        total = time.time() - t_wall
        final = {"final_loss": ema_loss, "steps": step,
                 "wall_s": total, "nan_steps": self.nan_steps,
                 "straggler_steps": self.straggler_steps}
        self._log(step, {"event": "done", **final})
        return final

    def _watchdog(self, step: int, dt: float) -> None:
        self._times.append(dt)
        if len(self._times) > 200:
            self._times = self._times[-100:]
        if len(self._times) >= 10:
            med = statistics.median(self._times)
            if dt > self.tcfg.straggler_factor * med:
                self.straggler_steps += 1
                self._log(step, {"event": "straggler", "step_s": dt,
                                 "median_s": med})

    def _log(self, step: int, rec: Dict) -> None:
        rec = {"step": step, **rec}
        with self.metrics_path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
