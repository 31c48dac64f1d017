"""Adaptive per-task buffer controllers for the async (FedAST) engine.

The port's counterpart of the JAX package's ``api/buffer.py``, numpy only
and bit-exact with it. After every flush the engine feeds the controller
a ``FlushObservation`` and reads back the per-task buffer sizes, so each
task's flush threshold may change flush by flush. Built-ins
(``BUFFER_CONTROLLERS``):

  * ``static``           — every task keeps the resolved initial size (the
    default).
  * ``staleness_target`` — steps a task's size toward a mean-staleness
    setpoint: too stale grows the buffer, too fresh shrinks it.
  * ``arrival_rate``     — splits ``S x initial`` buffered capacity by each
    task's share of completions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from repro_torch.api.registry import BUFFER_CONTROLLERS, register_buffer_controller


@dataclass
class FlushObservation:
    """What a controller sees after one flush."""

    flush: int  # 1-based flush count across all tasks
    task: int  # flushed task index
    time: float  # virtual time of the flush
    staleness_mean: float
    kept: int  # updates aggregated (post max_staleness filter)
    arrivals: np.ndarray  # (S,) cumulative completions per task
    sizes: np.ndarray  # (S,) buffer sizes in force at this flush


class BufferController:
    """Stateful per-task buffer-size protocol (the ``static`` built-in):
    ``reset(n_tasks, initial_size)`` once per run, ``observe`` per flush,
    ``sizes() -> (S,) int array`` whenever the engine needs the
    thresholds. ``state_dict`` is JSON-native and rides the async
    checkpoint payload; ``load_state(state_dict())`` restores the exact
    size trajectory."""

    name = "static"

    def reset(self, n_tasks: int, initial_size: int) -> None:
        self.n_tasks = int(n_tasks)
        self.initial_size = int(initial_size)
        self._sizes = np.full(self.n_tasks, self.initial_size, np.int64)

    def observe(self, obs: FlushObservation) -> None:
        del obs

    def sizes(self) -> np.ndarray:
        return self._sizes

    def state_dict(self) -> Dict[str, Any]:
        return {"sizes": self._sizes.tolist()}

    def load_state(self, state: Dict[str, Any]) -> None:
        if "sizes" in state:
            self._sizes = np.asarray(state["sizes"], np.int64)


# the protocol base IS the static controller: sizes never move
register_buffer_controller("static")(BufferController)


@register_buffer_controller("staleness_target")
class StalenessTargetController(BufferController):
    """Each flush of task ``s`` moves only that task's size by ``step``:
    up when the observed mean staleness exceeds ``target + deadband``,
    down when it falls below ``target - deadband``, clipped to
    ``[min_size, max_size]``."""

    name = "staleness_target"

    def __init__(self, target: float = 1.0, step: int = 1, min_size: int = 1,
                 max_size: int = 64, deadband: float = 0.25):
        if target < 0:
            raise ValueError(f"staleness_target: target must be >= 0, got {target}")
        if int(step) < 1:
            raise ValueError(f"staleness_target: step must be >= 1, got {step}")
        if not 1 <= int(min_size) <= int(max_size):
            raise ValueError(
                f"staleness_target: need 1 <= min_size <= max_size, "
                f"got ({min_size}, {max_size})")
        if deadband < 0:
            raise ValueError(f"staleness_target: deadband must be >= 0, got {deadband}")
        self.target = float(target)
        self.step = int(step)
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.deadband = float(deadband)

    def observe(self, obs: FlushObservation) -> None:
        s = obs.task
        if obs.staleness_mean > self.target + self.deadband:
            self._sizes[s] = min(self.max_size, int(self._sizes[s]) + self.step)
        elif obs.staleness_mean < self.target - self.deadband:
            self._sizes[s] = max(self.min_size, int(self._sizes[s]) - self.step)


@register_buffer_controller("arrival_rate")
class ArrivalRateController(BufferController):
    """Holds the total buffered capacity at ``n_tasks x initial_size`` and
    splits it by each task's share of cumulative completions, clipped to
    ``[min_size, max_size]``; the first ``warmup`` flushes keep the static
    sizes."""

    name = "arrival_rate"

    def __init__(self, min_size: int = 1, max_size: int = 64, warmup: int = 2):
        if not 1 <= int(min_size) <= int(max_size):
            raise ValueError(
                f"arrival_rate: need 1 <= min_size <= max_size, got ({min_size}, {max_size})")
        if int(warmup) < 0:
            raise ValueError(f"arrival_rate: warmup must be >= 0, got {warmup}")
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.warmup = int(warmup)

    def observe(self, obs: FlushObservation) -> None:
        total = int(np.asarray(obs.arrivals).sum())
        if obs.flush <= self.warmup or total == 0:
            return
        share = np.asarray(obs.arrivals, np.float64) / total
        raw = np.rint(self.n_tasks * self.initial_size * share)
        self._sizes = np.clip(raw, self.min_size, self.max_size).astype(np.int64)


def get_buffer_controller(name: str, options: dict | None = None) -> BufferController:
    """Instantiate a registered buffer controller from (name, options)."""
    cls = BUFFER_CONTROLLERS.get(name)
    return cls(**(options or {}))
