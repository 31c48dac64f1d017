"""Declarative scenario specification: one serializable object per run.

A ``ScenarioSpec`` is the single entry point for every MMFL experiment —
allocation strategy x task mix x client population x incentive mechanism
x runtime (sync lockstep rounds or the async FedAST-style engine). The
tree is plain dataclasses, JSON round-trippable (``to_json``/``from_json``
returns an equal spec), so sweeps and CI configs are data, not code.

Registry keys (``allocation.strategy``, ``policy.name``,
``clients.arrival_process``, ``auction.mechanism``, ``auction.incentive``,
``TaskSpec.family``) are validated against the registries at
``run_scenario`` time so a spec file can be authored before its plugin is
imported.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _from_dict(cls, data: Dict[str, Any]):
    """Build dataclass ``cls`` from ``data``, rejecting unknown keys."""
    if not isinstance(data, dict):
        raise TypeError(f"{cls.__name__}: expected a dict, got {type(data).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        msg = f"{cls.__name__}: unknown field(s) {sorted(unknown)}; valid: {sorted(names)}"
        raise ValueError(msg)
    return cls(**data)


@dataclass
class TaskSpec:
    """One concurrently-trained model. ``family`` picks the task family
    (``synthetic`` FedTask MLPs, ``arch`` production LM configs);
    ``options`` are family-specific knobs (e.g. ``n_range`` for synthetic,
    ``preset``/``seq``/``batch``/``tau`` for arch)."""

    name: str
    family: str = "synthetic"
    work: float = 1.0  # virtual-time cost of one local job (async)
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ClientPopulationSpec:
    """Who the clients are and when they are available."""

    n_clients: int = 16
    participation: float = 0.35  # sync: active fraction per round
    dropout_prob: float = 0.0  # sync: straggler drop-out probability
    # async speed heterogeneity (uniform | bimodal | lognormal)
    speed_profile: str = "uniform"
    speed_spread: float = 4.0
    slow_fraction: float = 0.5
    # async availability plugin (ARRIVAL_PROCESSES key)
    arrival_process: str = "always_on"
    arrival_options: Dict[str, Any] = field(default_factory=dict)
    # vectorized population subsystem (POPULATIONS key, e.g. "vectorized"):
    # holds ALL per-client state — eligibility, arrival streams, bids,
    # cost sampling and (with {"lazy_data": true}) on-demand data shards —
    # as struct-of-arrays, scaling scenarios to 100k-1M clients. None
    # keeps the legacy dict path; "vectorized" is bit-exact with it.
    population: Optional[str] = None
    population_options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AllocationSpec:
    """Client->task allocator (ALLOCATORS key) and its fairness knob.
    When ``ScenarioSpec.policy`` is absent, the strategy maps onto its
    bit-exact ``LegacyStrategyPolicy`` wrapper."""

    strategy: str = "fedfair"
    alpha: float = 3.0


@dataclass
class PolicySpec:
    """Stateful allocation policy (POLICIES key) + constructor options —
    e.g. ``PolicySpec("ucb_bandit", {"epsilon": 0.2})``. Overrides
    ``allocation.strategy`` (which still supplies ``alpha``); omit it for
    the legacy wrapper path."""

    name: str = "fedfair"
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AuctionSpec:
    """Recruitment incentive producing the eligibility matrix.
    ``mechanism`` names the auction (AUCTIONS key); ``incentive`` names
    the round-by-round protocol driving it (INCENTIVES key):
    ``one_shot`` (legacy, round 0 only) or ``periodic_auction``
    (re-auction every R rounds against the remaining budget; options in
    ``incentive_options``, e.g. ``{"every": 5}``). ``bid_model`` names a
    built-in bid generator (seeded by ``bid_seed``); ``bids`` may instead
    carry an explicit (K, S) matrix."""

    mechanism: str = "maxmin_fair"
    budget: float = 29.0
    bid_model: str = "uniform"
    bid_seed: int = 0
    bids: Optional[List[List[float]]] = None
    options: Dict[str, Any] = field(default_factory=dict)
    incentive: str = "one_shot"
    incentive_options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class RuntimeSpec:
    """sync | async runtime and its training knobs. Defaults mirror
    ``fed.trainer.TrainConfig`` / ``fed.async_engine.AsyncConfig`` so a
    spec omitting a field reproduces the trainer defaults exactly."""

    mode: str = "sync"
    # cohort execution backend (BACKENDS registry key: serial | vmap |
    # sharded | registered). "serial" is the bit-exact reference; validated
    # at run_scenario time so specs can be authored before a plugin import.
    backend: str = "serial"
    # shared local-training knobs
    rounds: int = 100
    tau: int = 5
    lr: float = 0.1
    batch_size: int = 32
    hidden: int = 64
    depth: int = 2
    deep_for: Tuple[str, ...] = ("synth-cifar",)
    deep_depth: int = 3
    eval_every: int = 1
    # async (FedAST) knobs. buffer_size=None derives a backend-aware
    # default: 4 (the FedAST default) on serial, max(4, device_count) on
    # the vmap/sharded backends so every flush can fill the device mesh.
    # An explicit buffer_size must be >= 1 (0/negative would flush every
    # arrival; rejected with ValueError at engine construction).
    total_arrivals: int = 400
    buffer_size: Optional[int] = None
    beta: float = 0.5
    server_lr: float = 1.0
    max_staleness: Optional[int] = None
    # async adaptive per-task buffer sizing (BUFFER_CONTROLLERS registry
    # key: static | staleness_target | arrival_rate | registered). None
    # keeps the bit-exact legacy behaviour (the "static" controller).
    buffer_controller: Optional[str] = None
    buffer_controller_options: Dict[str, Any] = field(default_factory=dict)
    # server aggregation rule (AGGREGATORS registry key: fedavg | fedavgm
    # | fedadam | fedyogi | fedmedian | trimmed_mean | registered),
    # applied by BOTH runtimes. None keeps the bit-exact legacy weighted
    # mean (the "fedavg" aggregator); options are constructor kwargs,
    # e.g. {"lr": 0.1, "eps": 1e-3} for fedadam.
    aggregator: Optional[str] = None
    aggregator_options: Dict[str, Any] = field(default_factory=dict)
    # client cost model (COST_MODELS registry key: constant | device_tiers
    # | lognormal_straggler | trace_replay | registered), applied by BOTH
    # runtimes: arrival processes schedule a job's dispatch, the cost
    # model determines its completion latency (async event times; sync
    # per-round clock = max over cohort latencies). None keeps the
    # bit-exact legacy timing (the "constant" model).
    cost_model: Optional[str] = None
    cost_model_options: Dict[str, Any] = field(default_factory=dict)
    # checkpoint/resume — mid-run full-state checkpoints for BOTH engines:
    # the arch sync round loop (every `checkpoint_every` rounds) and the
    # async event engine (every `checkpoint_every` flushes; the whole
    # event queue / buffers / RNG / policy / controller state is saved, so
    # a resumed async run is event-for-event identical to an
    # uninterrupted one)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    # retention: the CheckpointManager keeps the newest `checkpoint_keep`
    # complete steps and garbage-collects older ones after each save
    checkpoint_keep: int = 3
    resume: bool = False

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {self.mode!r}")
        self.deep_for = tuple(self.deep_for)


@dataclass
class ScenarioSpec:
    """The whole experiment: what to train, on whom, allocated how, under
    which incentive mechanism and runtime."""

    tasks: List[TaskSpec]
    name: str = "scenario"
    seed: int = 0
    data_seed: int = 0
    clients: ClientPopulationSpec = field(default_factory=ClientPopulationSpec)
    allocation: AllocationSpec = field(default_factory=AllocationSpec)
    policy: Optional[PolicySpec] = None
    auction: Optional[AuctionSpec] = None
    runtime: RuntimeSpec = field(default_factory=RuntimeSpec)

    def __post_init__(self):
        self.tasks = [_from_dict(TaskSpec, t) if isinstance(t, dict) else t for t in self.tasks]
        if not self.tasks:
            raise ValueError("ScenarioSpec needs at least one TaskSpec")
        if isinstance(self.clients, dict):
            self.clients = _from_dict(ClientPopulationSpec, self.clients)
        if isinstance(self.allocation, dict):
            self.allocation = _from_dict(AllocationSpec, self.allocation)
        if isinstance(self.policy, dict):
            self.policy = _from_dict(PolicySpec, self.policy)
        if isinstance(self.auction, dict):
            self.auction = _from_dict(AuctionSpec, self.auction)
        if isinstance(self.runtime, dict):
            self.runtime = _from_dict(RuntimeSpec, self.runtime)

    @property
    def family(self) -> str:
        fams = {t.family for t in self.tasks}
        if len(fams) != 1:
            raise ValueError(f"all tasks must share one family, got {sorted(fams)}")
        return next(iter(fams))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["runtime"]["deep_for"] = list(self.runtime.deep_for)
        if d["auction"] is None:
            del d["auction"]
        if d["policy"] is None:
            del d["policy"]
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ScenarioSpec":
        return _from_dict(cls, data)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
