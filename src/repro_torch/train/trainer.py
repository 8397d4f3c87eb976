"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py``:
  * periodic atomic checkpointing (``train.checkpoint``) + restore-on-start;
  * step-level fault recovery: a step that raises (injected in tests;
    a lost device or a preemption in production) restores the last
    checkpoint and replays the data from the restored step — ``data_fn``
    is a pure function of the step, so the replay is exact;
  * a straggler watchdog: an EWMA of the step's wall time; a step slower
    than ``straggler_factor`` × the EWMA is counted.

A step's wall time includes waiting for the parameters' device (the
counterpart of the reference's ``block_until_ready``): CUDA work is
asynchronous, and a host clock that does not wait would time the launches.
``reshard`` (the elastic mesh change) restores the newest checkpoint
onto new shardings, on any LM mesh (``checkpoint.restore(shardings=)``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class StepStats:
    step: int
    wall_s: float
    is_straggler: bool
    metrics: dict


def _wait(tree) -> None:
    """Wait for the device of ``tree``'s first tensor leaf."""
    leaf = next((t for t in ckpt_lib.leaves(tree)
                 if isinstance(t, torch.Tensor)), None)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 params, opt_state, data_fn: Callable[[int], Any]):
        """``step_fn(params, opt_state, batch) → (params, opt_state,
        metrics)``; ``data_fn(step)`` must be replayable (deterministic per
        step) — that is what makes restart-from-checkpoint exact."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data_fn = data_fn
        self.step = 0
        self.ewma_s: float | None = None
        self.straggler_steps: list[int] = []
        self.recoveries = 0
        self.history: list[StepStats] = []

    # ----------------------------------------------------------- lifecycle
    def _restore(self, step: int) -> None:
        state = ckpt_lib.restore(self.cfg.ckpt_dir, step,
                                 {"params": self.params,
                                  "opt": self.opt_state})
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = step

    def maybe_restore(self) -> int:
        last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if last is not None:
            self._restore(last)
        return self.step

    def save(self):
        ckpt_lib.save(self.cfg.ckpt_dir, self.step,
                      {"params": self.params, "opt": self.opt_state},
                      extra={"time": time.time()})

    # ------------------------------------------------------------- running
    def run(self, num_steps: int, fault_hook: Callable | None = None):
        """fault_hook(step) may raise to simulate a failure at that step."""
        target = self.step + num_steps
        while self.step < target:
            batch = self.data_fn(self.step)
            t0 = time.perf_counter()
            try:
                if fault_hook is not None:
                    fault_hook(self.step)
                out = self.step_fn(self.params, self.opt_state, batch)
                self.params, self.opt_state, metrics = out
                _wait(self.params)
            except Exception:
                # The recovery boundary: any failed step is retried from
                # the last checkpoint, up to max_retries in all.
                self.recoveries += 1
                if self.recoveries > self.cfg.max_retries:
                    raise
                restored = ckpt_lib.latest_step(self.cfg.ckpt_dir)
                if restored is not None:
                    self._restore(restored)
                continue
            wall = time.perf_counter() - t0
            straggler = (self.ewma_s is not None
                         and wall > self.cfg.straggler_factor * self.ewma_s)
            if straggler:
                self.straggler_steps.append(self.step)
            self.ewma_s = wall if self.ewma_s is None else (
                0.9 * self.ewma_s + 0.1 * wall)
            self.step += 1
            self.history.append(StepStats(
                self.step, wall, straggler,
                {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (torch.Tensor, int, float))}))
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
        self.save()
        return self.history

    # ------------------------------------------------------------- elastic
    def reshard(self, shardings_tree):
        """Re-place params/opt from the newest checkpoint onto new
        shardings (``{"params": ..., "opt": ...}`` of NamedShardings, on
        any mesh): the elastic mesh change of the reference.  Returns the
        step it resumes from."""
        last = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if last is None:
            raise RuntimeError("need a checkpoint to reshard from")
        state = ckpt_lib.restore(self.cfg.ckpt_dir, last,
                                 {"params": self.params,
                                  "opt": self.opt_state},
                                 shardings=shardings_tree)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = last
        return self.step
