"""Client cost models: how long a dispatched local job takes.

The port's counterpart of the JAX package's ``api/costmodel.py``, limited
to the ``constant`` model that the sync slice runs: every job costs
exactly its base duration, with no comm latency, no dropouts and no RNG
draws. A sync round's simulated duration is the max over its cohort's
latencies (the lockstep barrier), accumulated into ``wall_clock_sim``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.api.registry import COST_MODELS, register_cost_model


@dataclass
class LatencySample:
    """One sampled job cost: compute latency + network latency, in
    virtual-time units, plus whether the job drops out."""

    compute: float
    comm: float = 0.0
    dropout: bool = False

    @property
    def total(self) -> float:
        return self.compute + self.comm


@register_cost_model("constant")
class ClientCostModel:
    """Protocol base, and itself the ``constant`` model: a job costs
    exactly its ``base_duration`` and consumes no RNG. ``reset`` is called
    once per run with the model's own generator."""

    name = "constant"

    def reset(self, n_clients: int, n_tasks: int,
              rng: np.random.Generator,
              task_sizes: Optional[Sequence[float]] = None) -> None:
        self.n_clients = int(n_clients)
        self.n_tasks = int(n_tasks)
        self.rng = rng
        self.task_sizes = (None if task_sizes is None
                           else np.asarray(task_sizes, np.float64))

    def sample_latency(self, client: int, task: int, base_duration: float,
                       time: float = 0.0, version: int = 0
                       ) -> LatencySample:
        del client, task, time, version
        return LatencySample(compute=float(base_duration))


def get_cost_model(name: str,
                   options: Optional[Dict[str, Any]] = None
                   ) -> ClientCostModel:
    """Instantiate a registered cost model from (name, options); option
    mismatches surface the model + options instead of a bare
    constructor TypeError."""
    cls = COST_MODELS.get(name)
    try:
        return cls(**(options or {}))
    except TypeError as e:
        raise ValueError(
            f"cost_model {name!r} rejected options {options!r}: {e}"
        ) from None
