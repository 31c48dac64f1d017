"""Client cost models: how long a dispatched local job takes.

The port's counterpart of the JAX package's ``api/costmodel.py``, numpy
only and bit-exact with it:

  * ``constant``            — every job costs exactly its base duration,
    with no comm latency, no dropouts and no RNG draws;
  * ``device_tiers``        — compute tiers x bandwidth classes drawn per
    client from the model's own stream, scaled per task by model size;
  * ``lognormal_straggler`` — heavy-tailed lognormal latency, correlated
    stragglers fixed at reset, and a dropout probability;
  * ``trace_replay``        — per-client latency sequences from a JSON
    trace (or an inline dict), replayed cyclically.

The models' state (RNG stream, tier assignments, stragglers, trace
cursors) is JSON-native (``state_dict``/``load_state``) and rides the
engines' checkpoint payloads, so a resumed run samples mid-sequence.
Arrival processes schedule a job's dispatch; the cost model determines
its completion. A sync round's simulated duration is the max over its
cohort's latencies (the lockstep barrier), accumulated into
``wall_clock_sim``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

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

    def state_dict(self) -> Dict[str, Any]:
        return {"rng_state": self.rng.bit_generator.state}

    def load_state(self, state: Dict[str, Any]) -> None:
        if "rng_state" in state:
            self.rng.bit_generator.state = state["rng_state"]

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

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["speed"] = self._speed.tolist()
        state["rate"] = self._rate.tolist()
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        if "speed" in state:
            self._speed = np.asarray(state["speed"], np.float64)
            self._rate = np.asarray(state["rate"], np.float64)


@register_cost_model("lognormal_straggler")
class LognormalStraggler(ClientCostModel):
    """Heavy-tailed latency: each job's duration is the base scaled by a
    LogNormal(0, sigma) draw; a ``straggler_frac`` subset of clients
    (fixed at reset — CORRELATED stragglers, the same clients are
    persistently slow) is further scaled by ``straggler_factor``. With
    probability ``dropout_prob`` a job drops out: it still occupies the
    client until its completion event, but contributes no update — the
    async engine releases the pinned version and re-enqueues the
    client."""

    name = "lognormal_straggler"

    def __init__(self, sigma: float = 0.5, straggler_frac: float = 0.2,
                 straggler_factor: float = 4.0, dropout_prob: float = 0.0):
        if sigma < 0:
            raise ValueError(
                f"lognormal_straggler: sigma must be >= 0, got {sigma}")
        if not 0.0 <= straggler_frac <= 1.0:
            raise ValueError(
                "lognormal_straggler: straggler_frac must be in [0, 1], "
                f"got {straggler_frac}")
        if straggler_factor < 1.0:
            raise ValueError(
                "lognormal_straggler: straggler_factor must be >= 1, "
                f"got {straggler_factor}")
        if not 0.0 <= dropout_prob <= 1.0:
            raise ValueError(
                "lognormal_straggler: dropout_prob must be in [0, 1], "
                f"got {dropout_prob}")
        self.sigma = float(sigma)
        self.straggler_frac = float(straggler_frac)
        self.straggler_factor = float(straggler_factor)
        self.dropout_prob = float(dropout_prob)

    def reset(self, n_clients, n_tasks, rng, task_sizes=None) -> None:
        super().reset(n_clients, n_tasks, rng, task_sizes)
        self._straggler = rng.random(self.n_clients) < self.straggler_frac

    def sample_latency(self, client, task, base_duration, time=0.0,
                       version=0) -> LatencySample:
        del task, time, version
        mult = float(self.rng.lognormal(mean=0.0, sigma=self.sigma))
        if self._straggler[client]:
            mult *= self.straggler_factor
        dropped = (self.dropout_prob > 0.0
                   and float(self.rng.random()) < self.dropout_prob)
        return LatencySample(compute=float(base_duration) * mult,
                             dropout=dropped)

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["straggler"] = np.asarray(self._straggler, bool).tolist()
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        if "straggler" in state:
            self._straggler = np.asarray(state["straggler"], bool)


def _load_trace(path: Optional[str], trace: Optional[Dict[str, Any]]):
    """Load + validate a latency trace. Format (byteprofile-style

    per-device event sequences, flattened to latencies)::

        {"latencies": {"0": [1.2, 0.8, ...], "1": [...], "*": [...]}}

    Keys are client ids (or ``"*"`` as the fallback sequence for clients
    without their own); values are positive latency sequences replayed
    cyclically. Malformed traces raise ValueError naming the defect."""
    if (path is None) == (trace is None):
        raise ValueError(
            "trace_replay: exactly one of 'path' (a JSON trace file) or "
            "'trace' (an inline trace dict) is required")
    if path is not None:
        try:
            with open(path) as f:
                trace = json.load(f)
        except OSError as e:
            raise ValueError(
                f"trace_replay: cannot read trace file {path!r}: {e}"
            ) from None
        except json.JSONDecodeError as e:
            raise ValueError(
                f"trace_replay: {path!r} is not valid JSON: {e}") from None
    if not isinstance(trace, dict) or "latencies" not in trace:
        raise ValueError(
            "trace_replay: trace must be a dict with a 'latencies' key, "
            f"got {type(trace).__name__}")
    lat = trace["latencies"]
    if not isinstance(lat, dict) or not lat:
        raise ValueError(
            "trace_replay: 'latencies' must be a non-empty dict of "
            "client id (or '*') -> latency sequence")
    seqs: Dict[str, List[float]] = {}
    for key, seq in lat.items():
        if key != "*":
            try:
                int(key)
            except (TypeError, ValueError):
                raise ValueError(
                    "trace_replay: latency keys must be client ids or "
                    f"'*', got {key!r}") from None
        if not isinstance(seq, (list, tuple)) or not seq:
            raise ValueError(
                f"trace_replay: latency sequence for {key!r} must be a "
                "non-empty list")
        vals = []
        for v in seq:
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not np.isfinite(v) or v <= 0:
                raise ValueError(
                    "trace_replay: latencies must be finite positive "
                    f"numbers, got {v!r} for {key!r}")
            vals.append(float(v))
        seqs[str(key)] = vals
    return seqs


@register_cost_model("trace_replay")
class TraceReplay(ClientCostModel):
    """Replay EMPIRICAL latency distributions from a JSON trace file
    (byteprofile-style event replay): each client cycles deterministically
    through its recorded latency sequence (falling back to the ``"*"``
    sequence), scaled by ``scale`` and by the per-task model-size factor.
    The per-client cursors are checkpoint state, so a resumed run replays
    the trace mid-sequence."""

    name = "trace_replay"

    def __init__(self, path: Optional[str] = None,
                 trace: Optional[Dict[str, Any]] = None,
                 scale: float = 1.0):
        if scale <= 0:
            raise ValueError(
                f"trace_replay: scale must be > 0, got {scale}")
        self.path = path
        self.scale = float(scale)
        self._seqs = _load_trace(path, trace)

    def reset(self, n_clients, n_tasks, rng, task_sizes=None) -> None:
        super().reset(n_clients, n_tasks, rng, task_sizes)
        missing = [c for c in range(self.n_clients)
                   if str(c) not in self._seqs and "*" not in self._seqs]
        if missing:
            raise ValueError(
                f"trace_replay: no latency sequence for clients "
                f"{missing} and no '*' fallback in the trace")
        self._cursor = np.zeros(self.n_clients, np.int64)
        self._task_cost = self._relative_task_cost()

    def sample_latency(self, client, task, base_duration, time=0.0,
                       version=0) -> LatencySample:
        del base_duration, time, version
        seq = self._seqs.get(str(client)) or self._seqs["*"]
        lat = seq[int(self._cursor[client]) % len(seq)]
        self._cursor[client] += 1
        return LatencySample(
            compute=self.scale * lat * float(self._task_cost[task]))

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["cursor"] = self._cursor.tolist()
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        if "cursor" in state:
            self._cursor = np.asarray(state["cursor"], np.int64)


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
