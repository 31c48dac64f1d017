"""Client cost models: how long a dispatched local job takes.

The port's counterpart of the JAX package's ``api/costmodel.py``, numpy
only and bit-exact with it, limited to two models:

  * ``constant``     — every job costs exactly its base duration, with no
    comm latency, no dropouts and no RNG draws;
  * ``device_tiers`` — compute tiers x bandwidth classes drawn per client
    from the model's own stream, scaled per task by model size.

``lognormal_straggler`` and ``trace_replay`` are not ported yet
(``run_scenario`` refuses them), nor the models' ``state_dict`` /
``load_state``, which come with checkpointing. Arrival processes
schedule a job's dispatch; the cost model determines its completion. A
sync round's simulated duration is the max over its cohort's latencies
(the lockstep barrier), accumulated into ``wall_clock_sim``.
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

    def _relative_task_cost(self) -> np.ndarray:
        """Per-task model-size cost factors, normalised to mean 1.0;
        all-ones when the engine supplied no sizes."""
        if self.task_sizes is None or not len(self.task_sizes) \
                or not np.all(self.task_sizes > 0):
            return np.ones(self.n_tasks)
        return self.task_sizes / self.task_sizes.mean()


def _check_classes(kind: str, classes: Dict[str, Dict[str, float]],
                   rate_key: str) -> None:
    if not classes:
        raise ValueError(f"device_tiers: {kind} must not be empty")
    total = 0.0
    for name, c in classes.items():
        if rate_key not in c or "fraction" not in c:
            raise ValueError(
                f"device_tiers: {kind} entry {name!r} needs "
                f"{rate_key!r} and 'fraction' keys, got {sorted(c)}")
        if float(c[rate_key]) <= 0:
            raise ValueError(
                f"device_tiers: {kind} entry {name!r} has non-positive "
                f"{rate_key} {c[rate_key]}")
        if float(c["fraction"]) < 0:
            raise ValueError(
                f"device_tiers: {kind} entry {name!r} has negative "
                f"fraction {c['fraction']}")
        total += float(c["fraction"])
    if total <= 0:
        raise ValueError(f"device_tiers: {kind} fractions sum to 0")


@register_cost_model("device_tiers")
class DeviceTiers(ClientCostModel):
    """Parametric device heterogeneity: each client is assigned (at
    ``reset``, from the model's own RNG) a compute tier and a bandwidth
    class. Compute latency is ``base_duration * task_cost / tier_speed``,
    comm latency ``comm_scale * task_cost / bandwidth_rate``, where
    ``task_cost`` is the task's parameter count normalised to mean 1.
    Only the per-client assignments consume RNG."""

    name = "device_tiers"

    DEFAULT_TIERS = {
        "phone": {"speed": 0.25, "fraction": 0.3},
        "laptop": {"speed": 1.0, "fraction": 0.5},
        "server": {"speed": 4.0, "fraction": 0.2},
    }
    DEFAULT_BANDWIDTHS = {
        "cellular": {"rate": 1.0, "fraction": 0.4},
        "broadband": {"rate": 4.0, "fraction": 0.6},
    }

    def __init__(self, tiers: Optional[Dict[str, Dict[str, float]]] = None,
                 bandwidths: Optional[Dict[str, Dict[str, float]]] = None,
                 comm_scale: float = 0.25):
        if comm_scale < 0:
            raise ValueError(
                f"device_tiers: comm_scale must be >= 0, got {comm_scale}")
        self.tiers = dict(tiers if tiers is not None else self.DEFAULT_TIERS)
        self.bandwidths = dict(bandwidths if bandwidths is not None
                               else self.DEFAULT_BANDWIDTHS)
        _check_classes("tiers", self.tiers, "speed")
        _check_classes("bandwidths", self.bandwidths, "rate")
        self.comm_scale = float(comm_scale)

    @staticmethod
    def _assign(rng: np.random.Generator, n: int,
                classes: Dict[str, Dict[str, float]],
                rate_key: str) -> np.ndarray:
        names = sorted(classes)
        p = np.asarray([float(classes[c]["fraction"]) for c in names])
        idx = rng.choice(len(names), size=n, p=p / p.sum())
        return np.asarray([float(classes[names[i]][rate_key]) for i in idx])

    def reset(self, n_clients, n_tasks, rng, task_sizes=None) -> None:
        super().reset(n_clients, n_tasks, rng, task_sizes)
        self._speed = self._assign(rng, self.n_clients, self.tiers, "speed")
        self._rate = self._assign(rng, self.n_clients, self.bandwidths, "rate")
        self._task_cost = self._relative_task_cost()

    def sample_latency(self, client, task, base_duration, time=0.0,
                       version=0) -> LatencySample:
        del time, version
        cost = float(self._task_cost[task])
        return LatencySample(
            compute=float(base_duration) * cost / float(self._speed[client]),
            comm=self.comm_scale * cost / float(self._rate[client]))


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
