"""Fault-tolerant training loop.

The port of ``repro.train.loop``:

* restart-from-latest-checkpoint on startup (node-failure recovery path:
  the launcher simply re-executes the job);
* the checkpoint holds the data-iterator state -> bitwise-identical resume;
* async checkpointing off the critical path;
* per-step watchdog: step-time EWMA + z-score flags stragglers;
* pull-based prefetching data pipeline (a slow host can't stall the step).

A step's time ends with a read of its loss, which waits for the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.data.loader import PrefetchLoader, SyntheticLMStream
from repro_torch.train.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.train.elastic import StepWatchdog


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3


class Trainer:
    """Generic trainer over trees of tensors: step_fn(params, opt_state,
    batch) -> (params, opt_state, metrics)."""

    def __init__(
        self,
        step_fn: Callable,
        params: Any,
        opt_state: Any,
        stream: SyntheticLMStream,
        cfg: TrainLoopConfig,
        to_batch: Callable[[Dict[str, np.ndarray]], Any] = None,
    ):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.stream = stream
        self.cfg = cfg
        self.to_batch = to_batch or (lambda b: b)
        self.step = 0
        self.watchdog = StepWatchdog()
        self.ckpt = (
            AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_ckpts) if cfg.ckpt_dir else None
        )
        self._saved_step: Optional[int] = None
        self.history: list = []

    # -- fault tolerance -------------------------------------------------

    def try_resume(self) -> bool:
        """Node-failure recovery: restore (params, opt, data state) from the
        newest complete checkpoint, if any."""
        if not self.cfg.ckpt_dir or latest_step(self.cfg.ckpt_dir) is None:
            return False
        tree = {"params": self.params, "opt_state": self.opt_state}
        tree, step, extra = restore(self.cfg.ckpt_dir, tree)
        self.params = tree["params"]
        self.opt_state = tree["opt_state"]
        self.step = self._saved_step = step
        if "data_state" in extra:
            self.stream.load_state_dict(extra["data_state"])
        return True

    def _checkpoint(self) -> None:
        """Save this step unless it is saved already (the loop's exit after
        a step that ``ckpt_every`` just saved writes nothing twice)."""
        if self.ckpt is None or self._saved_step == self.step:
            return
        # data_state records the CONSUMED batch count (== train step; one
        # batch per step), NOT stream.state_dict(): the prefetch thread's
        # producer cursor runs ahead of consumption, and checkpointing it
        # would skip batches on resume.
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt_state": self.opt_state},
            extra={"data_state": {"step": self.step}},
        )
        self._saved_step = self.step

    # -- the loop ----------------------------------------------------------

    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        target = self.step + (steps if steps is not None else
                              self.cfg.total_steps - self.step)
        loader = PrefetchLoader(self.stream)
        try:
            while self.step < target:
                batch = self.to_batch(loader.next())
                t0 = time.time()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])   # waits for the device
                dt = time.time() - t0
                self.step += 1
                straggler = self.watchdog.observe(dt)
                if self.step % self.cfg.log_every == 0 or self.step == target:
                    self.history.append(
                        {"step": self.step, "loss": loss,
                         "sec_per_step": dt, "straggler": straggler})
                if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                    self._checkpoint()
        finally:
            loader.close()
            if self.ckpt is not None and self.cfg.ckpt_dir:
                self._checkpoint()
                self.ckpt.wait()
        return {
            "final_step": self.step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "history": self.history,
            "straggler_events": self.watchdog.events,
        }
