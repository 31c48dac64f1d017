"""Event-driven asynchronous MMFL engine (FedAST-style, staleness-aware).

The port's counterpart of the JAX package's ``fed/async_engine.py``. The
sync trainer's round barrier makes every task wait for the slowest
selected client; this engine removes it:

  - a virtual-time event queue of client completions (per-client speed
    drawn from a heterogeneity profile, latency from the cost model);
  - on completion a client is immediately re-assigned its next task by the
    allocation policy (``MMFLCoordinator.assign_next``);
  - per-task BUFFERED aggregation: the server folds a task's buffer into
    its global model every ``B`` arrivals (FedAST), B per task from a
    ``BufferController``;
  - STALENESS-weighted updates: an update computed from model version v
    and applied at version V gets weight p_k / (1 + V - v)^beta, applied
    to the client DELTA and normalised by the undiscounted weight sum.

Compute is lazy and batched: jobs carry only (client, task, version); the
local training runs at flush time, one ``ExecutionBackend.run_cohort`` per
dispatch version, over the same fold_in-keyed update rule as the sync
trainer. The fold is the pluggable ``Aggregator`` (``fedavg`` through the
backend; the server optimizers through ``kernels.fused_aggregate`` on a
card). With equal client speeds and ``B`` equal to the cohort size the
engine reproduces the sync round.

An incentive mechanism may re-recruit the eligible clients after every
flush (``ctx.round`` is the 1-based flush count). A client population
(``repro_torch.pop``) may own the speeds, the arrival process, the cost
model and the eligibility; the first everyone-starts wave then draws each
stream in one batched call.

Mid-run checkpoints: ``state_dict``/``load_state`` carry the BOUNDED
engine state (event queue, buffers, retained versions, RNG streams,
policy/incentive/controller state) through ``repro_torch.checkpoint``,
while the whole-run history (flush records and dispatch log) streams into
the ``history.jsonl`` sidecar, committed by offset with each step. The
layout is the reference's, so either package resumes the other's steps,
and a resumed run continues event for event as an uninterrupted one.
Params, retained versions and server moments are saved from the device
with one host copy per leaf and restored onto the engine's device.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api.aggregator import aggregator_from_config
from repro_torch.api.arrivals import get_arrival_process
from repro_torch.api.backend import ClientBatch, CohortTask, get_backend
from repro_torch.api.buffer import FlushObservation, get_buffer_controller
from repro_torch.api.costmodel import get_cost_model
from repro_torch.api.policy import AllocationPolicy, RoundContext, stacked_delta_norms
from repro_torch.checkpoint import to_device
from repro_torch.core.allocation import AllocationStrategy
from repro_torch.core.mmfl import MMFLCoordinator
from repro_torch.device import resolve_device
from repro_torch.fed.client import accuracy
from repro_torch.fed.data import FedTask
from repro_torch.fed.trainer import (cohort_update, fed_client_batch, fed_local_fn,
                                     init_task_model, task_round_key)
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class AsyncConfig:
    total_arrivals: int = 400      # client completions to process
    # B: aggregate every B arrivals per task. None derives a backend-aware
    # default (resolve_buffer_size)
    buffer_size: Optional[int] = None
    beta: float = 0.5              # staleness discount exponent
    server_lr: float = 1.0         # eta on the aggregated buffer delta
    alpha: float = 3.0
    strategy: AllocationStrategy = AllocationStrategy.FEDFAIR
    # stateful allocation policy (api.policy); None wraps `strategy`
    policy: Optional[AllocationPolicy] = None
    # client speed heterogeneity: "uniform", "bimodal" (slow_fraction of
    # clients at speed 1/speed_spread), "lognormal"
    speed_profile: str = "uniform"
    speed_spread: float = 4.0
    slow_fraction: float = 0.5
    # availability plugin (api.arrivals registry)
    arrival_process: str = "always_on"
    arrival_options: dict = field(default_factory=dict)
    max_staleness: Optional[int] = None   # drop updates staler than this
    # per-task buffer sizing (api.buffer key); None selects "static"
    buffer_controller: Optional[str] = None
    buffer_controller_options: dict = field(default_factory=dict)
    # server aggregation rule (api.aggregator key); None selects "fedavg"
    aggregator: Optional[str] = None
    aggregator_options: dict = field(default_factory=dict)
    # client cost model (api.costmodel key); None selects "constant"
    cost_model: Optional[str] = None
    cost_model_options: dict = field(default_factory=dict)
    # client population (pop POPULATIONS key); None keeps the per-client
    # state here, "vectorized" is bit-exact with it
    population: Optional[str] = None
    population_options: dict = field(default_factory=dict)
    # mid-run checkpoints: every `checkpoint_every` FLUSHES the engine
    # state is saved to checkpoint_dir, keeping the newest
    # `checkpoint_keep` steps; resume=True restores the newest complete
    # step and continues event for event
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    checkpoint_keep: int = 3
    resume: bool = False
    # cohort execution backend (api.backend BACKENDS key or instance)
    backend: str = "serial"
    # local training (mirrors sync TrainConfig)
    tau: int = 5
    lr: float = 0.1
    batch_size: int = 32
    hidden: int = 64
    depth: int = 2
    deep_for: tuple = ("synth-cifar",)
    deep_depth: int = 3
    seed: int = 0


def resolve_buffer_size(buffer_size, backend, device=None) -> int:
    """Backend-aware default cohort sizing: with ``buffer_size`` unset the
    device-parallel backends (vmap/sharded) flush in cohorts of at least
    the number of devices of the run's device type (CUDA cards for
    ``device=None``/"cuda", 1 for the CPU); serial and custom backends keep
    the FedAST default of 4. An explicit value wins, but must be >= 1."""
    if buffer_size is not None:
        if int(buffer_size) < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {buffer_size}: a "
                "non-positive buffer would flush every single arrival "
                "(leave it unset for the backend-aware default)")
        return int(buffer_size)
    name = backend if isinstance(backend, str) else getattr(backend, "name", "")
    if name in ("vmap", "sharded"):
        dev = torch.device("cuda" if device is None else device)
        return max(4, torch.cuda.device_count() if dev.type == "cuda" else 1)
    return 4


def client_speeds(profile: str, n: int, rng: np.random.Generator,
                  spread: float = 4.0, slow_fraction: float = 0.5) -> np.ndarray:
    """Per-client relative speeds > 0; a unit job takes 1/speed virtual
    time. ``spread`` is the slow:fast ratio (bimodal) or the log-scale
    dispersion anchor (lognormal)."""
    if profile == "uniform":
        return np.ones(n)
    if profile == "bimodal":
        speeds = np.ones(n)
        slow = rng.random(n) < slow_fraction
        speeds[slow] = 1.0 / spread
        return speeds
    if profile == "lognormal":
        sigma = np.log(max(spread, 1.0 + 1e-6)) / 2.0
        return rng.lognormal(mean=0.0, sigma=sigma, size=n)
    raise ValueError(f"unknown speed profile: {profile!r}")


class AsyncTask:
    """Adapter protocol the engine drives: the cohort update rule as
    ``local_fn`` plus the stacked per-client inputs via ``client_batch``,
    run through the ExecutionBackend. An adapter may also define
    ``accuracy(params) -> float`` (the arch family's next-token probe);
    when every task does, the history carries that measured accuracy
    (``AsyncHistory.acc_eval``) instead of ``1 - metric``. A legacy
    (pre-backend) adapter leaves ``local_fn`` unset and overrides
    ``update()`` instead; the flush then calls it with no backend
    dispatch."""

    name: str
    n_clients: int
    p_k: np.ndarray          # (K,) base aggregation weights
    work: float = 1.0        # virtual-time cost of one local job
    local_fn = None          # (params, keys, *client_data) -> (updates, losses)

    def init(self, seed: int):
        raise NotImplementedError

    def client_batch(self, seed: int, version: int, client_ids) -> ClientBatch:
        """Stacked inputs for ``local_fn``; a function of (seed, version,
        client_ids) only, so every engine and backend agrees."""
        raise NotImplementedError

    def update(self, params, seed: int, version: int, client_ids):
        """Reference cohort (leading axis len(client_ids)): ``local_fn``
        per client through the serial backend, on the params' device."""
        if self.local_fn is None:
            raise NotImplementedError(
                "AsyncTask adapters define local_fn + client_batch "
                "(ExecutionBackend protocol) or override update()")
        device = tree_leaves(params)[0].device
        return get_backend("serial", device).run_cohort(
            CohortTask(self.name, params, self.local_fn),
            self.client_batch(seed, version, client_ids)).updates

    def evaluate(self, params) -> float:
        """Prevailing f_s for Eq. 4 (lower is better: 1 - test accuracy)."""
        raise NotImplementedError


class FedAsyncTask(AsyncTask):
    """FedTask (synthetic MLP) adapter: the sync trainer's cohort update
    rule and key derivation, on ``device`` (None means CUDA)."""

    def __init__(self, task: FedTask, task_idx: int, cfg: AsyncConfig, device=None):
        self.task = task
        self.task_idx = task_idx
        self.cfg = cfg
        self.device = resolve_device(device)
        self.name = task.name
        self.n_clients = task.n_clients
        self.p_k = task.p_k
        self.work = 1.0
        self.local_fn = fed_local_fn(cfg.tau, cfg.lr, cfg.batch_size)
        self._test = (torch.from_numpy(task.test_x).to(self.device),
                      torch.from_numpy(task.test_y).to(self.device))

    def init(self, seed: int):
        return init_task_model(self.task, prng.fold_in(prng.PRNGKey(seed), self.task_idx),
                               self.cfg.hidden, self.cfg.depth, self.cfg.deep_for,
                               self.cfg.deep_depth, self.device)

    def client_batch(self, seed: int, version: int, client_ids) -> ClientBatch:
        return fed_client_batch(self.task, task_round_key(seed, self.task_idx, version),
                                client_ids, self.device)

    def update(self, params, seed: int, version: int, client_ids):
        return cohort_update(params, task_round_key(seed, self.task_idx, version), self.task,
                             client_ids, self.cfg.tau, self.cfg.lr, self.cfg.batch_size,
                             self.device)

    def evaluate(self, params) -> float:
        acc = float(accuracy(params, *self._test))
        return max(1.0 - acc, 1e-6)


@dataclass
class AsyncHistory:
    time: np.ndarray            # (F,) virtual time of each flush
    task: np.ndarray            # (F,) flushed task index
    metric: np.ndarray          # (F, S) prevailing f_s after the flush
    staleness_mean: np.ndarray  # (F,) mean staleness in the flushed buffer
    arrivals: np.ndarray        # (S,) total completions per task
    updates_per_client: np.ndarray  # (K,)
    versions: np.ndarray        # (S,) final model versions
    assignments: List[Tuple[int, int]]  # (client, task) dispatch log
    dropped: int = 0            # updates discarded for exceeding staleness
    cost_dropouts: int = 0      # jobs the cost model dropped out entirely
    # (F, S) per-task buffer sizes in force AFTER each flush
    buffer_sizes: Optional[np.ndarray] = None
    # (F, S) measured eval accuracy, when every task defines accuracy()
    # (the arch family); synthetic tasks keep 1 - f_s
    acc_eval: Optional[np.ndarray] = None
    acc: np.ndarray = field(init=False)
    min_acc: np.ndarray = field(init=False)
    var_acc: np.ndarray = field(init=False)
    # (F,) simulated wall clock of each flush: the event time itself
    wall_clock_sim: np.ndarray = field(init=False)

    def __post_init__(self):
        self.acc = self.acc_eval if self.acc_eval is not None else 1.0 - self.metric
        self.min_acc = self.acc.min(axis=1)
        self.var_acc = self.acc.var(axis=1)
        self.wall_clock_sim = self.time


@dataclass
class _Job:
    client: int
    task: int
    version: int       # model version the client trained FROM
    dispatch_time: float
    # sampled at dispatch by the cost model: the job occupies the client
    # until its completion event but contributes NO update
    dropout: bool = False


class AsyncMMFLEngine:
    """Virtual-time event loop: dispatch -> completion -> buffer -> flush.
    All K clients train continuously; each completion immediately triggers
    the client's next assignment. ``device=None`` means CUDA."""

    def __init__(self, tasks: Sequence[AsyncTask], cfg: AsyncConfig,
                 eligibility: Optional[np.ndarray] = None, incentive=None,
                 device=None):
        self.tasks = list(tasks)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.S = len(self.tasks)
        self.K = self.tasks[0].n_clients
        if any(t.n_clients != self.K for t in self.tasks):
            raise ValueError("all tasks must have the same number of clients")
        self.coord = MMFLCoordinator(
            task_names=[t.name for t in self.tasks], n_clients=self.K,
            alpha=cfg.alpha, strategy=cfg.strategy, seed=cfg.seed,
            eligibility=eligibility, policy=cfg.policy)
        # per-flush re-recruitment; one_shot never updates after round 0
        self.incentive = incentive
        self.buffer_size = resolve_buffer_size(cfg.buffer_size, cfg.backend, self.device)
        if cfg.buffer_controller is None and cfg.buffer_controller_options:
            raise ValueError(
                "buffer_controller_options were given without a "
                "buffer_controller; name one (e.g. 'staleness_target') "
                "or drop the options")
        try:
            self.controller = get_buffer_controller(cfg.buffer_controller or "static",
                                                    cfg.buffer_controller_options)
        except TypeError as e:
            raise ValueError(
                f"buffer_controller {cfg.buffer_controller!r} rejected "
                f"options {cfg.buffer_controller_options!r}: {e}") from None
        # per-client state: speeds (seed + 1), the arrival process (seed +
        # 2) and the cost model (seed + 3, reset in _init_state once the
        # params exist); with a population it OWNS all three, seeded and
        # drawn alike, and the engine aliases them
        if cfg.population is None and cfg.population_options:
            raise ValueError(
                "population_options were given without a population; "
                "name one (e.g. 'vectorized') or drop the options")
        self.population = None
        if cfg.population is not None:
            from repro_torch.pop import get_population

            self.population = get_population(
                cfg.population, cfg.population_options, n_clients=self.K, n_tasks=self.S,
                seed=cfg.seed, speed_profile=cfg.speed_profile, speed_spread=cfg.speed_spread,
                slow_fraction=cfg.slow_fraction, arrival_process=cfg.arrival_process,
                arrival_options=cfg.arrival_options, cost_model=cfg.cost_model,
                cost_model_options=cfg.cost_model_options)
            self.speeds = self.population.speeds
            self.arrival = self.population.arrival
            self.cost_model = self.population.cost_model
            self.coord.eligibility = self.population.set_eligibility(self.coord.eligibility)
        else:
            self.speeds = client_speeds(
                cfg.speed_profile, self.K, np.random.default_rng(cfg.seed + 1),
                spread=cfg.speed_spread, slow_fraction=cfg.slow_fraction)
            self.arrival = get_arrival_process(cfg.arrival_process, cfg.arrival_options)
            self.arrival.reset(self.K, np.random.default_rng(cfg.seed + 2))
            if cfg.cost_model is None and cfg.cost_model_options:
                raise ValueError(
                    "cost_model_options were given without a cost_model; "
                    "name one (e.g. 'device_tiers') or drop the options")
            self.cost_model = get_cost_model(cfg.cost_model or "constant",
                                             cfg.cost_model_options)
        self.backend = get_backend(cfg.backend, self.device)
        self.aggregator = aggregator_from_config(cfg.aggregator, cfg.aggregator_options,
                                                 backend=self.backend)
        self._has_acc = all(hasattr(t, "accuracy") for t in self.tasks)
        # the active CheckpointManager (None when checkpointing is off):
        # _dispatch and _flush stream their history records through it
        self._ckpt = None

    @classmethod
    def from_fed_tasks(cls, tasks: Sequence[FedTask], cfg: AsyncConfig,
                       eligibility: Optional[np.ndarray] = None,
                       device=None) -> "AsyncMMFLEngine":
        return cls([FedAsyncTask(t, s, cfg, device) for s, t in enumerate(tasks)],
                   cfg, eligibility, device=device)

    # -- internals ---------------------------------------------------------

    def _retain(self, s: int, version: int, params):
        slot = self._retained[s].setdefault(version, [params, 0])
        slot[1] += 1

    def _release(self, s: int, version: int):
        slot = self._retained[s][version]
        slot[1] -= 1
        if slot[1] == 0:
            del self._retained[s][version]

    def _record(self, rec: dict) -> None:
        """Append one history record to the checkpoint sidecar (buffered;
        committed by the next save)."""
        if self._ckpt is not None:
            self._ckpt.append_history(rec)

    def _dispatch(self, client: int, t: float):
        with span("mmfl.allocate"):
            s = self.coord.assign_next(client)
            if s is None:
                return                       # not eligible for anything: idle
            v = self._version[s]
            self._retain(s, v, self._params[s])
            self._assignments.append((client, s))
            self._record({"kind": "assign", "client": int(client), "task": int(s)})
            # the arrival process may defer the job's start; the model version
            # is pinned at dispatch; the cost model turns work/speed into the
            # job's completion latency
            start = self.arrival.next_start(client, t)
            base = self.tasks[s].work / self.speeds[client]
            lat = self.cost_model.sample_latency(client, s, base, time=start, version=v)
            self._seq += 1
            heapq.heappush(self._events,
                           (start + lat.total, self._seq,
                            _Job(client, s, v, start, bool(lat.dropout))))

    def _dispatch_all(self, clients, t: float):
        """Population-batched dispatch of many clients at one virtual time
        (the first everyone-starts wave). Assignment stays a per-client
        coordinator walk (its RNG order is the contract); the arrival and
        cost draws batch into one call per stream, each stream seeing the
        same client-id-ordered draws as the scalar loop."""
        with span("mmfl.allocate"):
            assigned = []
            for i in clients:
                s = self.coord.assign_next(int(i))
                if s is None:
                    continue                 # not eligible for anything: idle
                v = self._version[s]
                self._retain(s, v, self._params[s])
                self._assignments.append((int(i), s))
                self._record({"kind": "assign", "client": int(i), "task": int(s)})
                assigned.append((int(i), s, v))
            if not assigned:
                return
            ids, tasks, vers = (np.array(col, np.int64) for col in zip(*assigned))
            starts = self.population.next_arrivals(ids, t)
            works = np.array([self.tasks[s].work for s in tasks], np.float64)
            totals, drops = self.population.sample_latencies(
                ids, tasks, works / self.speeds[ids], times=starts, versions=vers)
            for k in range(len(assigned)):
                self._seq += 1
                heapq.heappush(self._events,
                               (starts[k] + totals[k], self._seq,
                                _Job(int(ids[k]), int(tasks[k]), int(vers[k]), float(starts[k]),
                                     bool(drops[k]))))

    def _set_eligibility(self, elig) -> np.ndarray:
        """Adopt a (K, S) eligibility matrix, mirroring it into the
        population's struct-of-arrays when there is one."""
        elig = np.asarray(elig, bool)
        if self.population is not None:
            return self.population.set_eligibility(elig)
        return elig

    def _flush(self, s: int, t: float):
        cfg = self.cfg
        buf = self._buffers[s]
        self._buffers[s] = []
        cur = self._version[s]
        kept: List[_Job] = []
        for j in buf:
            if cfg.max_staleness is not None and cur - j.version > cfg.max_staleness:
                self._dropped += 1
                self._release(s, j.version)
            else:
                kept.append(j)
        if not kept:
            return
        # one backend cohort per distinct dispatch version, stacked in
        # sorted-version order, then group order
        task = self.tasks[s]
        deltas, weights, stale = [], [], []
        by_version: Dict[int, List[_Job]] = {}
        for j in kept:
            by_version.setdefault(j.version, []).append(j)
        for v in sorted(by_version):
            group = by_version[v]
            ids = np.array([j.client for j in group], np.int64)
            base = self._retained[s][v][0]
            if task.local_fn is None:
                # legacy adapter: only update() is defined, no backend dispatch
                cohort = task.update(base, cfg.seed, v, ids)
            else:
                with span("mmfl.batch"):
                    batch = task.client_batch(cfg.seed, v, ids)
                cohort = self.backend.run_cohort(CohortTask(task.name, base, task.local_fn),
                                                 batch).updates
            deltas.append(tree_map(lambda c, b: c - b, cohort, base))
            for j in group:
                weights.append(task.p_k[j.client])
                stale.append(cur - v)
                self._release(s, v)
        stacked = deltas[0] if len(deltas) == 1 else tree_map(
            lambda *leaves: torch.cat(leaves), *deltas)
        # FedAST staleness discount on the weights, normalised by the
        # UNDISCOUNTED sum, folded by the pluggable aggregator
        w = torch.from_numpy(np.asarray(weights, np.float32))
        agg, self._server_state[s] = self.aggregator.aggregate_stale(
            stacked, w, np.asarray(stale, np.float32), cfg.beta,
            self._server_state[s], normalizer=w.sum())
        self._params[s] = tree_map(lambda p, d: p + cfg.server_lr * d, self._params[s], agg)
        self._version[s] = cur + 1
        with span("mmfl.eval"):
            self._metric[s] = task.evaluate(self._params[s])
        self.coord.report(task.name, self._metric[s])
        # policy feedback: this flush's allocation counts (and, when the
        # policy opts in, the mean delta norm of the buffer)
        counts = np.zeros(self.S, np.int64)
        counts[s] = len(kept)
        norms = None
        if self.coord.wants_update_norms:
            norms = np.full(self.S, np.nan)
            norms[s] = float(stacked_delta_norms(stacked).mean())
        self.coord.observe(counts, norms, task=s)
        self._n_flushes += 1
        if self.incentive is not None:
            upd = self.incentive.recruit(RoundContext(
                round=self._n_flushes, task_names=self.coord.task_names,
                losses=self.coord.losses, alpha=cfg.alpha, n_clients=self.K,
                eligibility=self.coord.eligibility))
            if upd is not None:
                self.coord.eligibility = self._set_eligibility(upd.eligibility)
        if self._has_acc:
            self._acc[s] = float(task.accuracy(self._params[s]))
            self._hist_acc.append(self._acc.copy())
        stale_mean = float(np.mean(stale))
        # the controller sees this flush's feedback and emits the sizes in
        # force from the next arrival on
        self.controller.observe(FlushObservation(
            flush=self._n_flushes, task=s, time=float(t),
            staleness_mean=stale_mean, kept=len(kept),
            arrivals=self._arrivals.copy(), sizes=self._buffer_sizes.copy()))
        self._buffer_sizes = np.asarray(self.controller.sizes(), np.int64).copy()
        self._hist_time.append(t)
        self._hist_task.append(s)
        self._hist_metric.append(self._metric.copy())
        self._hist_stale.append(stale_mean)
        self._hist_bufsz.append(self._buffer_sizes.copy())
        rec = {"kind": "flush", "time": float(t), "task": int(s),
               "metric": [float(x) for x in self._metric], "stale": float(stale_mean),
               "buffer_sizes": [int(x) for x in self._buffer_sizes]}
        if self._has_acc:
            rec["acc"] = [float(x) for x in self._acc]
        self._record(rec)

    # -- checkpoint state --------------------------------------------------

    def _init_state(self):
        """Fresh run state."""
        cfg = self.cfg
        self.controller.reset(self.S, self.buffer_size)
        self._buffer_sizes = np.asarray(self.controller.sizes(), np.int64).copy()
        self._params = [t.init(cfg.seed) for t in self.tasks]
        self._server_state = [self.aggregator.init(p) for p in self._params]
        self._metric = np.array([t.evaluate(p) for t, p in zip(self.tasks, self._params)])
        for t, f in zip(self.tasks, self._metric):
            self.coord.report(t.name, float(f))
        self._version = [0] * self.S
        self._buffers: List[List[_Job]] = [[] for _ in range(self.S)]
        self._retained: List[Dict[int, list]] = [{} for _ in range(self.S)]
        self._events: list = []
        self._seq = 0
        self._dropped = 0
        self._n_flushes = 0
        self._processed = 0
        self._assignments: List[Tuple[int, int]] = []
        self._hist_time, self._hist_task = [], []
        self._hist_metric, self._hist_stale = [], []
        self._hist_bufsz: List[np.ndarray] = []
        self._hist_acc: List[np.ndarray] = []
        self._acc = (np.array([float(t.accuracy(p)) for t, p in zip(self.tasks, self._params)])
                     if self._has_acc else None)
        self._arrivals = np.zeros(self.S, np.int64)
        self._per_client = np.zeros(self.K, np.int64)
        self._cost_dropouts = 0
        self.cost_model.reset(self.K, self.S, np.random.default_rng(cfg.seed + 3),
                              task_sizes=self._task_sizes())
        if self.population is not None:      # everyone starts training:
            self._dispatch_all(range(self.K), 0.0)   # batched, bit-exact
        else:
            for i in range(self.K):
                self._dispatch(i, 0.0)

    def _task_sizes(self) -> List[float]:
        """Per-task parameter counts (cost-model size scaling input)."""
        return [float(sum(leaf.numel() for leaf in tree_leaves(p))) for p in self._params]

    @staticmethod
    def _job_payload(j: _Job) -> list:
        return [int(j.client), int(j.task), int(j.version), float(j.dispatch_time),
                bool(j.dropout)]

    @staticmethod
    def _job_from_payload(p: Sequence) -> _Job:
        # steps from before the cost models carry 4-element payloads (no
        # dropout flag); those jobs never drop out
        c, s, v, dt = p[:4]
        return _Job(int(c), int(s), int(v), float(dt), bool(p[4]) if len(p) > 4 else False)

    def state_dict(self) -> Dict:
        """The BOUNDED control state of a mid-run engine, JSON-native: the
        event queue (in-flight jobs), per-task buffers, retained-version
        refcounts, staleness and arrival bookkeeping, the RNG streams, and
        the policy, incentive, controller and cost-model state. What grows
        with run length (the flush history and the dispatch log) streams
        into the sidecar instead (``_record``), so the step payload is
        O(1) in run length. The model pytrees (params, retained versions,
        server state) travel through ``save_pytree``
        (``_save_checkpoint``). ``load_state(state_dict(), trees,
        history=history_records())`` continues event for event."""
        state = {
            "processed": int(self._processed),
            "n_flushes": int(self._n_flushes),
            "seq": int(self._seq),
            "dropped": int(self._dropped),
            "cost_dropouts": int(self._cost_dropouts),
            "version": [int(v) for v in self._version],
            "metric": [float(m) for m in self._metric],
            "acc": None if self._acc is None else [float(a) for a in self._acc],
            "events": [[float(t), int(seq), self._job_payload(j)] for t, seq, j in self._events],
            "buffers": [[self._job_payload(j) for j in buf] for buf in self._buffers],
            "retained": [{str(v): int(slot[1]) for v, slot in r.items()}
                         for r in self._retained],
            "arrivals": self._arrivals.tolist(),
            "per_client": self._per_client.tolist(),
            "buffer_sizes": [int(v) for v in self._buffer_sizes],
            "controller": self.controller.state_dict(),
            # the aggregator's config record; the server state pytrees
            # travel with the params
            "aggregator": self.aggregator.state_dict(),
            "coordinator": self.coord.state_dict(),
            # an incentive may re-recruit mid-run, and the coordinator
            # state does not hold the matrix
            "eligibility": np.asarray(self.coord.eligibility, bool).tolist(),
            "arrival": self.arrival.state_dict(),
            "cost_model": self.cost_model.state_dict(),
        }
        if self.population is not None:
            # config stamp only: the population's streams and eligibility
            # are captured above through the aliased objects
            state["population"] = self.population.config_record()
        if self.incentive is not None:
            state["incentive"] = self.incentive.state_dict()
        return state

    def history_records(self) -> List[dict]:
        """The in-memory history as sidecar records (what ``_record``
        appends, but for the interleaving of assign and flush records:
        replay partitions by kind). Serialises an engine without a
        manager, and backfills the sidecar after resuming a step with
        embedded history."""
        recs: List[dict] = [{"kind": "assign", "client": int(c), "task": int(s)}
                            for c, s in self._assignments]
        for i in range(len(self._hist_time)):
            rec = {"kind": "flush", "time": float(self._hist_time[i]),
                   "task": int(self._hist_task[i]),
                   "metric": [float(x) for x in self._hist_metric[i]],
                   "stale": float(self._hist_stale[i]),
                   "buffer_sizes": [int(x) for x in self._hist_bufsz[i]]}
            if i < len(self._hist_acc):
                rec["acc"] = [float(x) for x in self._hist_acc[i]]
            recs.append(rec)
        return recs

    def _replay_history(self, records: Sequence[dict]) -> None:
        """Rebuild the whole-run history lists and the dispatch log from
        replayed sidecar records."""
        self._assignments = [(int(r["client"]), int(r["task"]))
                             for r in records if r["kind"] == "assign"]
        self._hist_time, self._hist_task = [], []
        self._hist_metric, self._hist_stale = [], []
        self._hist_bufsz, self._hist_acc = [], []
        for r in records:
            if r["kind"] != "flush":
                continue
            self._hist_time.append(float(r["time"]))
            self._hist_task.append(int(r["task"]))
            self._hist_metric.append(np.asarray(r["metric"], np.float64))
            self._hist_stale.append(float(r["stale"]))
            self._hist_bufsz.append(np.asarray(r["buffer_sizes"], np.int64))
            if "acc" in r:
                self._hist_acc.append(np.asarray(r["acc"], np.float64))

    def load_state(self, state: Dict, task_params: Dict,
                   history: Optional[Sequence[dict]] = None) -> None:
        """Inverse of ``state_dict``. ``task_params`` maps task name to
        ``{"params", "retained": {str(version): tree}, "server_state"?}``
        (tensors on any device; they land on the engine's). ``history`` is
        the replayed record stream; omitted for a step whose state embeds
        the history."""
        dev = self.device
        self.controller.reset(self.S, self.buffer_size)
        self._processed = int(state["processed"])
        self._n_flushes = int(state["n_flushes"])
        self._seq = int(state["seq"])
        self._dropped = int(state["dropped"])
        self._cost_dropouts = int(state.get("cost_dropouts", 0))
        self._version = [int(v) for v in state["version"]]
        self._metric = np.asarray(state["metric"], np.float64)
        self._acc = None if state["acc"] is None else np.asarray(state["acc"], np.float64)
        self._events = [(t, int(seq), self._job_from_payload(payload))
                        for t, seq, payload in state["events"]]
        self._buffers = [[self._job_from_payload(payload) for payload in buf]
                         for buf in state["buffers"]]
        if "aggregator" in state:
            # raises for another rule or options (the moments would be
            # reinterpreted)
            self.aggregator.load_state(state["aggregator"])
        self._params, self._retained, self._server_state = [], [], []
        for s, task in enumerate(self.tasks):
            tree = task_params[task.name]
            self._params.append(to_device(tree["params"], dev))
            srv = tree.get("server_state")
            # steps from before the aggregators carry no server state:
            # re-init (exact for the stateless fedavg)
            self._server_state.append(to_device(srv, dev) if srv is not None
                                      else self.aggregator.init(self._params[s]))
            self._retained.append({int(v): [to_device(tree["retained"][v], dev), int(cnt)]
                                   for v, cnt in state["retained"][s].items()})
        self._arrivals = np.asarray(state["arrivals"], np.int64)
        self._per_client = np.asarray(state["per_client"], np.int64)
        if history is not None:
            self._replay_history(history)
        elif "history" in state:
            # embedded-history payload (before the sidecar), read only
            hist = state["history"]
            self._assignments = [(int(c), int(s)) for c, s in state["assignments"]]
            self._hist_time = list(hist["time"])
            self._hist_task = [int(x) for x in hist["task"]]
            self._hist_metric = [np.asarray(m, np.float64) for m in hist["metric"]]
            self._hist_stale = list(hist["stale"])
            self._hist_acc = [np.asarray(a, np.float64) for a in hist["acc"]]
            self._hist_bufsz = [np.asarray(b, np.int64) for b in hist["buffer_sizes"]]
        else:
            self._replay_history([])
        self._buffer_sizes = np.asarray(state["buffer_sizes"], np.int64)
        self.controller.load_state(state["controller"])
        self.coord.load_state(state["coordinator"])
        if self.population is not None and "population" in state:
            self.population.validate_config(state["population"])
        self.coord.eligibility = self._set_eligibility(state["eligibility"])
        self.arrival.load_state(state["arrival"])
        # reset first (assignments and cursors sized to this run), then
        # the saved sampling state over it; steps from before the cost
        # models carry none (exact for the stateless "constant")
        self.cost_model.reset(self.K, self.S, np.random.default_rng(self.cfg.seed + 3),
                              task_sizes=self._task_sizes())
        if "cost_model" in state:
            self.cost_model.load_state(state["cost_model"])
        if self.incentive is not None and "incentive" in state:
            self.incentive.load_state(state["incentive"])
        # an engine loaded directly (no manager) continues on run()
        self._state_loaded = True

    def _save_checkpoint(self, ckpt) -> None:
        """One checkpoint step, keyed by flush count: the params, every
        RETAINED dispatch version (in-flight jobs aggregate against the
        base they trained from) and the server state of a stateful rule as
        pytrees; everything else in the step's JSON payload."""
        trees = {}
        for s, task in enumerate(self.tasks):
            trees[task.name] = {
                "params": self._params[s],
                "retained": {str(v): slot[0] for v, slot in self._retained[s].items()},
            }
            if self._server_state[s] is not None:
                trees[task.name]["server_state"] = self._server_state[s]
        ckpt.save(self._n_flushes, trees, coordinator_state={"async": self.state_dict()},
                  engine_kind="async")

    # -- run loop ----------------------------------------------------------

    def run(self, verbose: bool = False) -> AsyncHistory:
        cfg = self.cfg
        ckpt = None
        if cfg.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager

            ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep)
        # the resume preamble (CheckpointManager.begin); an engine loaded
        # directly (load_state without a manager) skips both paths
        resumed = getattr(self, "_state_loaded", False)
        self._ckpt = ckpt
        if ckpt is not None:
            hit = ckpt.begin("async", cfg.resume, clear_stale=not resumed)
            if hit is not None:
                self.load_state(hit.coordinator["async"], hit.tasks, history=hit.history)
                resumed = True
                if hit.history is None:
                    # embedded-history step: backfill the sidecar so the
                    # next save commits the full history in the new layout
                    for rec in self.history_records():
                        ckpt.append_history(rec)
                if verbose:
                    print(f"resumed from flush {hit.step} (arrival {self._processed})")
        if not resumed:
            self._init_state()
        self._state_loaded = False
        while self._processed < cfg.total_arrivals and self._events:
            t, _, job = heapq.heappop(self._events)
            self._processed += 1
            if job.dropout:
                # cost-model dropout: the client was busy until now but
                # contributes no update; counts against total_arrivals
                self._cost_dropouts += 1
                self._release(job.task, job.version)
                self._dispatch(job.client, t)
                continue
            self._arrivals[job.task] += 1
            self._per_client[job.client] += 1
            self._buffers[job.task].append(job)
            flushes_before = self._n_flushes
            if len(self._buffers[job.task]) >= self._buffer_sizes[job.task]:
                self._flush(job.task, t)
                # a controller may have SHRUNK other tasks' sizes below
                # their occupancy: sweep so their buffers flush promptly
                # (a no-op under "static")
                swept = True
                while swept:
                    swept = False
                    for s in range(self.S):
                        if self._buffers[s] and len(self._buffers[s]) >= self._buffer_sizes[s]:
                            self._flush(s, t)
                            swept = True
            self._dispatch(job.client, t)
            if verbose and self._processed % 50 == 0:
                f = " ".join(f"{m:.3f}" for m in self._metric)
                print(f"  arrival {self._processed:5d} t={t:8.2f} f_s=[{f}]")
            # save when the flush count CROSSES a multiple of the cadence
            # (one arrival can flush several tasks through the sweep)
            if (ckpt is not None and cfg.checkpoint_every > 0
                    and self._n_flushes // cfg.checkpoint_every
                    > flushes_before // cfg.checkpoint_every):
                self._save_checkpoint(ckpt)
        if ckpt is not None:
            ckpt.close()
        self._ckpt = None
        return AsyncHistory(
            time=np.array(self._hist_time),
            task=np.array(self._hist_task, np.int64),
            metric=(np.array(self._hist_metric) if self._hist_metric
                    else np.zeros((0, self.S))),
            staleness_mean=np.array(self._hist_stale),
            arrivals=self._arrivals,
            updates_per_client=self._per_client,
            versions=np.array(self._version, np.int64),
            assignments=self._assignments, dropped=self._dropped,
            cost_dropouts=self._cost_dropouts,
            buffer_sizes=np.array(self._hist_bufsz, np.int64).reshape(-1, self.S),
            acc_eval=(np.array(self._hist_acc).reshape(-1, self.S) if self._has_acc else None))
