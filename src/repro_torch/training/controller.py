"""Fault-tolerant training controller.

Runs the training loop with:
  - periodic (async) checkpointing through ``checkpoint.CheckpointManager``,
  - automatic restart from the latest checkpoint after a (simulated or real)
    failure — the restart path is the same code as cold start,
  - TTL'd retry of failed steps (the paper's requeue mechanism applied to
    training steps: a step that dies is retried from the last checkpoint up
    to ``step_ttl`` times before aborting),
  - straggler tracking: a step exceeding ``straggler_factor`` x the moving
    average step time is recorded and feeds the profiler metrics.

A step's time runs until its new parameters are on the device: for CUDA
parameters the loop synchronises the card after each step.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.profiler import MasterProfiler, ProfilerConfig
from ..models.params import tree_leaves

__all__ = ["TrainController", "TrainControllerConfig"]

Tree = Any
# under the checkout's build/, which git ignores
DEFAULT_CHECKPOINT_DIR = str(
    Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "train_ckpt")


@dataclasses.dataclass
class TrainControllerConfig:
    checkpoint_dir: str = DEFAULT_CHECKPOINT_DIR
    checkpoint_every: int = 50
    async_checkpoint: bool = True
    step_ttl: int = 3
    straggler_factor: float = 3.0
    keep_checkpoints: int = 3


def _block_until_ready(params: Tree) -> None:
    leaf = tree_leaves(params)[0]
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


class TrainController:
    def __init__(
        self,
        train_step: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree, Dict]],
        config: Optional[TrainControllerConfig] = None,
    ):
        self.cfg = config or TrainControllerConfig()
        self.train_step = train_step
        self.ckpt = CheckpointManager(self.cfg.checkpoint_dir,
                                      keep=self.cfg.keep_checkpoints)
        self.profiler = MasterProfiler(ProfilerConfig(window=32, default_size=0.5))
        self.stragglers: List[int] = []
        self.restarts: int = 0

    # ---- restore-or-init ---------------------------------------------------------
    def init_state(
        self, init_fn: Callable[[], Tuple[Tree, Tree]]
    ) -> Tuple[Tree, Tree, int]:
        """Restore from the latest checkpoint if present, else cold-start."""
        latest = self.ckpt.latest_step()
        params, opt_state = init_fn()
        if latest is None:
            return params, opt_state, 0
        combined = self.ckpt.restore(latest, {"p": params, "o": opt_state})
        return combined["p"], combined["o"], latest

    # ---- main loop -----------------------------------------------------------------
    def run(
        self,
        params: Tree,
        opt_state: Tree,
        batches: Iterator[Tree],
        *,
        num_steps: int,
        start_step: int = 0,
        fail_at: Optional[int] = None,   # simulated failure injection (tests)
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
    ) -> Tuple[Tree, Tree, Dict[str, Any]]:
        cfg = self.cfg
        step = start_step
        step_times: List[float] = []
        metrics: Dict[str, Any] = {}
        attempts = 0

        while step < num_steps:
            try:
                batch = next(batches)
            except StopIteration:
                break
            t0 = time.perf_counter()
            try:
                if fail_at is not None and step == fail_at and attempts == 0:
                    attempts += 1
                    raise RuntimeError(f"injected failure at step {step}")
                params, opt_state, metrics = self.train_step(params, opt_state, batch)
                _block_until_ready(params)
            except Exception:
                # failure path: restart from the latest checkpoint (TTL'd)
                self.restarts += 1
                if self.restarts > cfg.step_ttl:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is not None:
                    combined = self.ckpt.restore(latest, {"p": params, "o": opt_state})
                    params, opt_state = combined["p"], combined["o"]
                    step = latest
                continue

            dt = time.perf_counter() - t0
            if step_times and dt > cfg.straggler_factor * float(np.mean(step_times[-16:])):
                self.stragglers.append(step)
            step_times.append(dt)
            self.profiler.observe("train_step", min(1.0, dt))

            step += 1
            if step % cfg.checkpoint_every == 0 or step == num_steps:
                self.ckpt.save(step, {"p": params, "o": opt_state},
                               blocking=not cfg.async_checkpoint)
            if on_metrics is not None:
                on_metrics(step, metrics)

        self.ckpt.wait()
        summary = {
            "final_step": step,
            "restarts": self.restarts,
            "stragglers": self.stragglers,
            "mean_step_time": float(np.mean(step_times)) if step_times else 0.0,
            "step_times": step_times,
            "last_metrics": metrics,
        }
        return params, opt_state, summary
