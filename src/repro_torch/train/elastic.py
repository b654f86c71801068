"""Straggler mitigation + elastic-scaling hooks.

On a real multi-pod deployment:
* the StepWatchdog's flags feed a controller that can (a) exclude a slow
  host from the next data-parallel rendezvous, (b) trigger an elastic
  re-mesh (checkpoints are sharding-agnostic: train/checkpoint.py), or
  (c) pre-emptively checkpoint when failure probability rises;
* ``replan_mesh`` computes the largest valid (data, model) mesh for a
  degraded device count — the restart path after losing nodes.

The port of ``repro.train.elastic``, a copy (plain Python).  The watchdog
and replanner are fully exercised in tests on CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class StepWatchdog:
    """EWMA step-timer; flags steps slower than mean + k*std (stragglers)."""

    def __init__(self, alpha: float = 0.1, k: float = 3.0, warmup: int = 5):
        self.alpha = alpha
        self.k = k
        self.warmup = warmup
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.events: List[Tuple[int, float]] = []

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = False
        std = self.var ** 0.5
        if self.n > self.warmup and dt > self.mean + self.k * max(std, 0.05 * self.mean):
            self.events.append((self.n, dt))
            is_straggler = True
            # do NOT absorb outliers into the EWMA
            return True
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def replan_mesh(n_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for a degraded device count.

    Keeps the model axis fixed (TP degree is architecture-determined) and
    shrinks data parallelism: 512 -> 496 devices with model=16 yields
    (31, 16). Raises if even one model group doesn't fit."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot fit model-parallel degree {model_parallel} on {n_devices} devices")
    data = n_devices // model_parallel
    return data, model_parallel


@dataclasses.dataclass
class ElasticPlan:
    old_devices: int
    new_devices: int
    mesh_shape: Tuple[int, int]
    action: str

    @classmethod
    def on_failure(cls, old_devices: int, failed: int, model_parallel: int) -> "ElasticPlan":
        new = old_devices - failed
        shape = replan_mesh(new, model_parallel)
        return cls(old_devices, shape[0] * shape[1], shape,
                   action="restore-from-checkpoint-with-smaller-mesh")
