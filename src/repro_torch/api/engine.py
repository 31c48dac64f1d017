"""`run_scenario`: one entry point for every MMFL run, sync or async.

The port's counterpart of the JAX package's ``api/engine.py``. A
``ScenarioSpec`` resolves through the registries to a task family
(synthetic FedTask MLPs, or the ``arch`` family of production LMs: the
four dense configs and zamba2-7b), an optional recruitment auction and its
incentive mechanism
(which produce the eligibility matrix), and either the sync lockstep
round loop or the async FedAST engine, and returns the same
``RunResult`` as the reference. Client populations and mid-run
checkpoints with resume run in every engine, in the reference's
checkpoint layout. Every backend runs (``serial``, ``vmap`` and
``sharded``); no spec feature is ignored.

    result = run_scenario(ScenarioSpec(tasks=[TaskSpec("synth-mnist")]))
    result.fairness["min_acc"], result.to_json()
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch.api.aggregator import aggregator_from_config
from repro_torch.api.backend import ClientBatch, CohortTask, get_backend
from repro_torch.api.costmodel import get_cost_model
from repro_torch.api.policy import (RoundContext, incentive_from_spec, policy_from_spec,
                                    stacked_delta_norms)
from repro_torch.api.registry import (
    AGGREGATORS,
    ALLOCATORS,
    ARRIVAL_PROCESSES,
    BACKENDS,
    BUFFER_CONTROLLERS,
    COST_MODELS,
    POLICIES,
    POPULATIONS,
    TASK_FAMILIES,
    register_task_family,
)
from repro_torch.api.spec import ScenarioSpec
from repro_torch.core.fairness import fairness_report, time_to_accuracy_report
from repro_torch.core.mmfl import MMFLCoordinator
from repro_torch.device import resolve_device
from repro_torch.checkpoint import CheckpointManager, to_device
from repro_torch.fed.async_engine import AsyncConfig, AsyncMMFLEngine, FedAsyncTask
from repro_torch.fed.data import _RECIPES, make_synthetic_task, task_seed
from repro_torch.fed.trainer import MMFLTrainer, TrainConfig
from repro_torch.launch.train import (ArchAsyncTask, assemble_batch, build_task, make_arch_eval,
                                      make_dataset)
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class RunResult:
    """What a scenario run returns.

    ``loss`` is the per-eval prevailing f_s curve (1 - accuracy for
    synthetic tasks); ``acc`` the accuracy curve. ``params`` are the final
    per-task models, as tensors on the run's device.
    """

    scenario: str
    mode: str
    task_names: List[str]
    loss: np.ndarray  # (T, S)
    acc: Optional[np.ndarray]  # (T, S) or None
    arrivals: np.ndarray  # (S,) total client updates per task
    alloc_counts: Optional[np.ndarray] = None  # (T, S) sync per-round
    time: Optional[np.ndarray] = None  # (T,) async virtual times
    virtual_time: float = 0.0
    wall_time: float = 0.0
    fairness: Dict[str, Any] = field(default_factory=dict)
    spec: Optional[ScenarioSpec] = None
    alloc: Optional[np.ndarray] = None  # sync (T, K) assignment trace
    assignments: Optional[List] = None
    staleness_mean: Optional[np.ndarray] = None
    versions: Optional[np.ndarray] = None
    buffer_sizes: Optional[np.ndarray] = None
    dropped: int = 0
    # (T,) cumulative per-round simulated clock (round time = max over
    # cohort latencies)
    wall_clock_sim: Optional[np.ndarray] = None
    cost_dropouts: int = 0
    auction: Optional[Dict[str, Any]] = None
    params: Optional[List] = None  # final per-task model pytrees

    def __post_init__(self):
        if not self.fairness:
            self.fairness = self._fairness()

    def _fairness(self) -> Dict[str, Any]:
        if self.acc is not None and len(self.acc):
            rep = fairness_report(self.acc[-1])
            rep["worst_task"] = self.task_names[int(np.argmin(self.acc[-1]))]
            return rep
        if len(self.loss) == 0:
            return {}
        last = np.asarray(self.loss[-1], np.float64)
        return {
            "min_loss": float(last.min()),
            "max_loss": float(last.max()),
            "mean_loss": float(last.mean()),
            "var_loss": float(last.var()),
            "worst_task": self.task_names[int(np.argmax(last))],
        }

    @property
    def min_acc(self) -> np.ndarray:
        if self.acc is None:
            raise ValueError("this task family does not define accuracy")
        return self.acc.min(axis=1)

    @property
    def var_acc(self) -> np.ndarray:
        if self.acc is None:
            raise ValueError("this task family does not define accuracy")
        return self.acc.var(axis=1)

    def time_to_accuracy(self, target: float) -> Dict[str, Any]:
        """Per-task simulated time to first reach ``target`` accuracy plus
        the cross-task spread (``core.fairness.time_to_accuracy_report``),
        on the cost-model clock (the round index when there is none)."""
        if self.acc is None:
            raise ValueError("this task family does not define accuracy")
        times = self.wall_clock_sim
        if times is None:
            times = self.time
        if times is None:
            times = np.arange(1, len(self.acc) + 1, dtype=np.float64)
        return time_to_accuracy_report(times, self.acc, target, self.task_names)

    @property
    def final_loss(self) -> Dict[str, float]:
        if len(self.loss) == 0:
            return {}
        return {n: float(v) for n, v in zip(self.task_names, self.loss[-1])}

    def to_json(self) -> Dict[str, Any]:
        """JSON-native summary (curves + fairness)."""

        def arr(a):
            return None if a is None else np.asarray(a).tolist()

        out = {
            "scenario": self.scenario,
            "mode": self.mode,
            "task_names": list(self.task_names),
            "loss": arr(self.loss),
            "acc": arr(self.acc),
            "time": arr(self.time),
            "arrivals": arr(self.arrivals),
            "alloc_counts": arr(self.alloc_counts),
            "virtual_time": float(self.virtual_time),
            "wall_time": float(self.wall_time),
            "wall_clock_sim": arr(self.wall_clock_sim),
            "dropped": int(self.dropped),
            "cost_dropouts": int(self.cost_dropouts),
            "versions": arr(self.versions),
            "buffer_sizes": arr(self.buffer_sizes),
            "final_buffer_sizes": (
                None
                if self.buffer_sizes is None or not len(self.buffer_sizes)
                else np.asarray(self.buffer_sizes)[-1].tolist()
            ),
            "fairness": self.fairness,
            "final_loss": self.final_loss,
        }
        if self.auction is not None:
            out["auction"] = self.auction
        if self.spec is not None:
            out["spec"] = self.spec.to_dict()
        return out


class Engine(Protocol):
    """What a runtime looks like to a caller: build from a spec, run, get
    a RunResult."""

    def run(self, verbose: bool = False) -> RunResult: ...


def _train_config(spec: ScenarioSpec) -> TrainConfig:
    rt, pop, al = spec.runtime, spec.clients, spec.allocation
    return TrainConfig(
        rounds=rt.rounds,
        alpha=al.alpha,
        participation=pop.participation,
        tau=rt.tau,
        lr=rt.lr,
        batch_size=rt.batch_size,
        hidden=rt.hidden,
        depth=rt.depth,
        strategy=ALLOCATORS.get(al.strategy),
        seed=spec.seed,
        dropout_prob=pop.dropout_prob,
        deep_for=tuple(rt.deep_for),
        deep_depth=rt.deep_depth,
        backend=rt.backend,
        policy=policy_from_spec(spec.policy, al.strategy),
        aggregator=rt.aggregator,
        aggregator_options=dict(rt.aggregator_options),
        cost_model=rt.cost_model,
        cost_model_options=dict(rt.cost_model_options),
        population=pop.population,
        population_options=dict(pop.population_options),
        checkpoint_dir=rt.checkpoint_dir,
        checkpoint_every=rt.checkpoint_every,
        checkpoint_keep=rt.checkpoint_keep,
        resume=rt.resume,
    )


def _async_config(spec: ScenarioSpec) -> AsyncConfig:
    rt, pop, al = spec.runtime, spec.clients, spec.allocation
    return AsyncConfig(
        total_arrivals=rt.total_arrivals,
        buffer_size=rt.buffer_size,
        beta=rt.beta,
        server_lr=rt.server_lr,
        alpha=al.alpha,
        strategy=ALLOCATORS.get(al.strategy),
        speed_profile=pop.speed_profile,
        speed_spread=pop.speed_spread,
        slow_fraction=pop.slow_fraction,
        arrival_process=pop.arrival_process,
        arrival_options=dict(pop.arrival_options),
        max_staleness=rt.max_staleness,
        buffer_controller=rt.buffer_controller,
        buffer_controller_options=dict(rt.buffer_controller_options),
        aggregator=rt.aggregator,
        aggregator_options=dict(rt.aggregator_options),
        cost_model=rt.cost_model,
        cost_model_options=dict(rt.cost_model_options),
        population=pop.population,
        population_options=dict(pop.population_options),
        checkpoint_dir=rt.checkpoint_dir,
        checkpoint_every=rt.checkpoint_every,
        checkpoint_keep=rt.checkpoint_keep,
        resume=rt.resume,
        backend=rt.backend,
        tau=rt.tau,
        lr=rt.lr,
        batch_size=rt.batch_size,
        hidden=rt.hidden,
        depth=rt.depth,
        deep_for=tuple(rt.deep_for),
        deep_depth=rt.deep_depth,
        seed=spec.seed,
        policy=policy_from_spec(spec.policy, al.strategy),
    )


class SyncFedEngine:
    """The sync lockstep round loop (``MMFLTrainer``) behind the Engine
    protocol."""

    def __init__(self, spec: ScenarioSpec, tasks, eligibility=None, incentive=None,
                 device=None):
        self.spec = spec
        self.trainer = MMFLTrainer(tasks, _train_config(spec), eligibility=eligibility,
                                   incentive=incentive, device=device)

    def run(self, verbose: bool = False) -> RunResult:
        h = self.trainer.run(verbose=verbose)
        return RunResult(
            scenario=self.spec.name,
            mode="sync",
            task_names=[t.name for t in self.trainer.tasks],
            loss=np.maximum(1.0 - h.acc, 1e-6),
            acc=h.acc,
            arrivals=h.alloc_counts.sum(axis=0),
            alloc_counts=h.alloc_counts,
            alloc=h.alloc,
            wall_clock_sim=h.wall_clock_sim,
            spec=self.spec,
            params=self.trainer.params,
        )


class AsyncEngineRunner:
    """The async FedAST-style engine behind the Engine protocol."""

    def __init__(self, spec: ScenarioSpec, engine: AsyncMMFLEngine, has_acc: bool):
        self.spec = spec
        self.engine = engine
        self.has_acc = has_acc

    def run(self, verbose: bool = False) -> RunResult:
        h = self.engine.run(verbose=verbose)
        return RunResult(
            scenario=self.spec.name,
            mode="async",
            task_names=[t.name for t in self.engine.tasks],
            loss=h.metric,
            acc=h.acc if self.has_acc else None,
            arrivals=h.arrivals,
            time=h.time,
            virtual_time=float(h.time[-1]) if len(h.time) else 0.0,
            staleness_mean=h.staleness_mean,
            versions=h.versions,
            buffer_sizes=h.buffer_sizes,
            dropped=h.dropped,
            wall_clock_sim=h.wall_clock_sim,
            cost_dropouts=h.cost_dropouts,
            assignments=h.assignments,
            spec=self.spec,
            params=self.engine._params,
        )


@register_task_family("synthetic")
class SyntheticFamily:
    """Class-conditional Gaussian FedTasks (``fed.data``). TaskSpec
    options: any ``make_synthetic_task`` kwarg (``n_range``, ``non_iid``,
    recipe overrides). Seeding matches the reference exactly. With a
    population and ``lazy_data``, client shards are made on first dispatch
    (``pop.data.LazyFedTask``) instead of an eager (K, n_max, dim) array."""

    def build_tasks(self, spec: ScenarioSpec):
        ctor = make_synthetic_task
        if (spec.clients.population is not None
                and spec.clients.population_options.get("lazy_data")):
            from repro_torch.pop import LazyFedTask

            ctor = LazyFedTask
        tasks = []
        for i, ts in enumerate(spec.tasks):
            base = ts.name.split("#")[0]
            if base not in _RECIPES:
                recipes = ", ".join(sorted(_RECIPES))
                raise KeyError(f"unknown synthetic task {ts.name!r}; recipes: {recipes}")
            kw = dict(_RECIPES[base])
            kw.update(ts.options)
            if "n_range" in kw:
                kw["n_range"] = tuple(kw["n_range"])
            tasks.append(ctor(task_seed(spec.data_seed, i), ts.name, spec.clients.n_clients,
                              **kw))
        return tasks

    def sync_engine(self, spec: ScenarioSpec, eligibility=None, incentive=None,
                    device=None) -> Engine:
        return SyncFedEngine(spec, self.build_tasks(spec), eligibility, incentive, device)

    def async_engine(self, spec: ScenarioSpec, eligibility=None, incentive=None,
                     device=None) -> Engine:
        acfg = _async_config(spec)
        adapters = [FedAsyncTask(t, s, acfg, device)
                    for s, t in enumerate(self.build_tasks(spec))]
        for a, ts in zip(adapters, spec.tasks):
            a.work = ts.work
        engine = AsyncMMFLEngine(adapters, acfg, eligibility, incentive, device=device)
        return AsyncEngineRunner(spec, engine, has_acc=True)


@register_task_family("arch")
class ArchFamily:
    """Production LM architectures (``launch.train``): per-arch train steps
    on synthetic non-iid token shards. TaskSpec options: ``preset``,
    ``seq``, ``batch``, ``tau``, ``local_lr``, ``shards``. Every arch of
    the config registry runs; an arch type the JAX package does not have
    is refused when a task is built."""

    def build_tasks(self, spec: ScenarioSpec, device=None):
        tasks, data = {}, {}
        for i, ts in enumerate(spec.tasks):
            o = ts.options
            seq = o.get("seq", 64)
            tasks[ts.name] = build_task(ts.name, o.get("preset", "tiny"), seq, o.get("batch", 8),
                                        tau=o.get("tau", 1), local_lr=o.get("local_lr", 5e-3),
                                        device=device)
            data[ts.name] = make_dataset(None, tasks[ts.name]["cfg"], spec.clients.n_clients,
                                         o.get("shards", 4), seq, seed=spec.data_seed + i)
        return tasks, data

    def sync_engine(self, spec: ScenarioSpec, eligibility=None, incentive=None,
                    device=None) -> Engine:
        tasks, data = self.build_tasks(spec, device)
        return ArchSyncEngine(spec, tasks, data, eligibility, incentive, device)

    def async_engine(self, spec: ScenarioSpec, eligibility=None, incentive=None,
                     device=None) -> Engine:
        tasks, data = self.build_tasks(spec, device)
        adapters = []
        for i, ts in enumerate(spec.tasks):
            a = ArchAsyncTask(ts.name, i, tasks[ts.name], data[ts.name],
                              tau=max(ts.options.get("tau", 1), 1),
                              local_lr=ts.options.get("local_lr", 5e-3))
            a.work = ts.work
            adapters.append(a)
        engine = AsyncMMFLEngine(adapters, _async_config(spec), eligibility, incentive,
                                 device=device)
        # ArchAsyncTask defines accuracy(): the history carries a measured
        # next-token accuracy curve
        return AsyncEngineRunner(spec, engine, has_acc=True)


class ArchSyncEngine:
    """The sync round loop of the arch family: MMFLCoordinator allocation
    -> per-arch cohort dispatch through the ExecutionBackend API ->
    loss/accuracy report, on the cost-model clock, with the incentive
    mechanism re-recruiting each round.

    tau>1 tasks run TRUE FedAvg: each cohort row's tau local SGD steps run
    through ``backend.run_cohort`` and fold through the aggregator
    (``fedavg``: ``backend.aggregate``, the fedavg kernel under ``vmap``
    on a card). tau<=1 tasks are the fused weighted-gradient AdamW server
    step, dispatched as a single-unit cohort so every engine shares one
    execution seam. With a population, it owns the cost model and the
    eligibility. Checkpoints (engine kind ``sync``) hold each task's
    ``params`` and ``opt`` (and ``server_state`` for a stateful
    aggregator) and the coordinator payload; the round curves stream into
    the sidecar, so a resumed run continues round for round.
    """

    def __init__(self, spec: ScenarioSpec, tasks, data, eligibility=None, incentive=None,
                 device=None):
        self.spec = spec
        self.tasks = tasks
        self.data = data
        self.device = resolve_device(device)
        self.names = [t.name for t in spec.tasks]
        self.backend = get_backend(spec.runtime.backend, device)
        # server aggregation rule of the tau>1 tasks; tau<=1 tasks step
        # their own AdamW inside the cohort
        self.aggregator = aggregator_from_config(spec.runtime.aggregator,
                                                 spec.runtime.aggregator_options,
                                                 backend=self.backend)
        self._server_state = {
            a: (self.aggregator.init(tasks[a]["params"]) if tasks[a]["tau"] > 1 else None)
            for a in self.names}
        self._eval_acc = {a: make_arch_eval(tasks[a], data[a])[1] for a in self.names}
        # each round's simulated duration is the max over the cohort's
        # sampled latencies (the lockstep barrier); a population owns the
        # cost model and the eligibility, and the engine aliases them
        self.population = None
        if spec.clients.population is not None:
            from repro_torch.pop import get_population

            self.population = get_population(
                spec.clients.population, spec.clients.population_options,
                n_clients=spec.clients.n_clients, n_tasks=len(self.names), seed=spec.seed,
                cost_model=spec.runtime.cost_model,
                cost_model_options=spec.runtime.cost_model_options)
            self.cost_model = self.population.cost_model
        else:
            self.cost_model = get_cost_model(spec.runtime.cost_model or "constant",
                                              spec.runtime.cost_model_options)
        self.coord = MMFLCoordinator(
            task_names=self.names,
            n_clients=spec.clients.n_clients,
            alpha=spec.allocation.alpha,
            strategy=ALLOCATORS.get(spec.allocation.strategy),
            participation=spec.clients.participation,
            seed=spec.seed,
            eligibility=eligibility,
            policy=policy_from_spec(spec.policy, spec.allocation.strategy))
        if self.population is not None:
            self.coord.eligibility = self.population.set_eligibility(self.coord.eligibility)
        self.incentive = incentive

    def _set_eligibility(self, elig) -> np.ndarray:
        """Adopt a (K, S) eligibility matrix, mirroring it into the
        population's struct-of-arrays when there is one."""
        elig = np.asarray(elig, bool)
        if self.population is not None:
            return self.population.set_eligibility(elig)
        return elig

    def _run_task_round(self, name: str, ids, rng, want_norm: bool = False):
        """One task's round: cohort execution + aggregation through the
        backend. Returns (reported loss, mean cohort update norm or None,
        computed only when the allocation policy opts in)."""
        t = self.tasks[name]
        w = self.coord.client_weights(ids)
        with span("mmfl.batch"):
            batch = assemble_batch(t, self.data[name], ids, w, rng)
        if t["tau"] <= 1:
            # the fused server step as a SINGLE-unit cohort (state = params
            # and opt; the p_k weighting lives in the batch's client_weights)
            job = ClientBatch(ids[:1], None, (tree_map(lambda v: v[None], batch),))
            state = CohortTask(name, (t["params"], t["opt"]), t["opt_local_fn"])
            res = self.backend.run_cohort(state, job)
            norm = None
            if want_norm:
                # displacement of the params (not the opt state) by the step
                norm = float(stacked_delta_norms(res.updates[0], t["params"])[0])
            t["params"], t["opt"] = tree_map(lambda leaf: leaf[0], res.updates)
            return float(res.losses[0]), norm
        # TRUE FedAvg: one cohort row per batch row (clients tiled to the
        # task batch size, as assemble_batch lays them out); the rows'
        # losses are unweighted
        w_rows = batch["client_weights"]
        rows = {k: v[:, None] for k, v in batch.items() if k != "client_weights"}
        reps = int(np.ceil(len(w_rows) / max(len(ids), 1)))
        row_ids = np.tile(np.asarray(ids), reps)[: len(w_rows)]
        res = self.backend.run_cohort(CohortTask(name, t["params"], t["local_fn"]),
                                      ClientBatch(row_ids, None, (rows,)))
        norm = None
        if want_norm:
            norm = float(stacked_delta_norms(res.updates, t["params"]).mean())
        # the pluggable server fold ("fedavg": the backend's weighted mean
        # of the absolute cohort params, the reference's trace)
        t["params"], self._server_state[name] = self.aggregator.aggregate_params(
            t["params"], res.updates, w_rows, self._server_state[name],
            normalizer=torch.clamp(w_rows.sum(), min=1e-9))
        return float(res.losses.mean()), norm

    def _resume(self, ckpt, hist: dict, rng) -> int:
        """Restore the newest complete step (if resuming): params, opt and
        server state onto the engine's device, the coordinator payload,
        and the curves before the step into ``hist``. Returns the round to
        start from."""
        hit = ckpt.begin("sync", self.spec.runtime.resume)
        if hit is None:
            return 0
        saved, coord = hit.tasks, hit.coordinator
        if "aggregator" in coord:
            # raises for another rule or options
            self.aggregator.load_state(coord["aggregator"])
        for a in self.names:
            if a in saved:
                self.tasks[a]["params"] = to_device(saved[a]["params"], self.device)
                self.tasks[a]["opt"] = to_device(saved[a]["opt"], self.device)
                srv = saved[a].get("server_state")
                if srv is not None:
                    self._server_state[a] = to_device(srv, self.device)
        if "coordinator" not in coord:        # a payload of the coordinator alone
            self.coord.load_state(coord)
            return hit.step
        self.coord.load_state(coord["coordinator"])
        rng.bit_generator.state = coord["data_rng"]
        if "population" in coord and self.population is not None:
            self.population.validate_config(coord["population"])
        # the incentive's ledger and re-auctioned eligibility
        if self.incentive is not None and "incentive" in coord:
            self.incentive.load_state(coord["incentive"])
            if self.incentive.eligibility is not None:
                self.coord.eligibility = self._set_eligibility(self.incentive.eligibility)
        if hit.history is not None:
            for rec in hit.history:
                if rec.get("kind") != "round":
                    continue
                hist["loss"].append(list(rec["loss"]))
                hist["counts"].append(list(rec["counts"]))
                hist["alloc"].append(np.asarray(rec["alloc"], np.int64))
                if "acc" in rec:
                    hist["acc"].append(list(rec["acc"]))
                if "wall_clock" in rec:
                    hist["wall_clock"].append(float(rec["wall_clock"]))
        else:
            # a step with its history embedded in the payload (before the
            # sidecar): read it, then backfill the sidecar below
            old = coord.get("history", {})
            hist["loss"][:] = [list(x) for x in old.get("loss", [])]
            hist["counts"][:] = [list(x) for x in old.get("counts", [])]
            hist["alloc"][:] = [np.asarray(x, np.int64) for x in old.get("alloc", [])]
            hist["acc"][:] = [list(x) for x in old.get("acc", [])]
            hist["wall_clock"][:] = [float(x) for x in old.get("wall_clock", [])]
        # steps without an accuracy curve or a clock: report each only
        # when it covers the restored rounds
        for key in ("acc", "wall_clock"):
            if len(hist[key]) != len(hist["loss"]):
                hist[key].clear()
        if hit.history is None:
            for i in range(len(hist["loss"])):
                rec = {"kind": "round", "loss": list(hist["loss"][i]),
                       "counts": list(hist["counts"][i]),
                       "alloc": np.asarray(hist["alloc"][i]).tolist()}
                if hist["acc"]:
                    rec["acc"] = list(hist["acc"][i])
                if hist["wall_clock"]:
                    rec["wall_clock"] = float(hist["wall_clock"][i])
                ckpt.append_history(rec)
        if "cost_model" in coord:
            self.cost_model.load_state(coord["cost_model"])
        return hit.step

    def _save(self, ckpt, step: int, rng) -> None:
        trees = {}
        for a in self.names:
            trees[a] = {"params": self.tasks[a]["params"], "opt": self.tasks[a]["opt"]}
            if self._server_state[a] is not None:
                trees[a]["server_state"] = self._server_state[a]
        coord = {"coordinator": self.coord.state_dict(), "data_rng": rng.bit_generator.state,
                 "aggregator": self.aggregator.state_dict(),
                 "cost_model": self.cost_model.state_dict()}
        if self.population is not None:
            coord["population"] = self.population.config_record()
        if self.incentive is not None:
            coord["incentive"] = self.incentive.state_dict()
        ckpt.save(step, trees, coordinator_state=coord, engine_kind="sync")

    def run(self, verbose: bool = False) -> RunResult:
        spec, rt = self.spec, self.spec.runtime
        rng = np.random.default_rng(spec.seed)
        hist = {"loss": [], "counts": [], "alloc": [], "acc": [], "wall_clock": []}
        # the cost model samples from its OWN stream (seed + 3), sized by
        # the per-task parameter counts
        self.cost_model.reset(
            spec.clients.n_clients, len(self.names), np.random.default_rng(spec.seed + 3),
            task_sizes=[float(sum(leaf.numel() for leaf in tree_leaves(self.tasks[a]["params"])))
                        for a in self.names])
        ckpt, start_round = None, 0
        if rt.checkpoint_dir:
            ckpt = CheckpointManager(rt.checkpoint_dir, keep=rt.checkpoint_keep)
            start_round = self._resume(ckpt, hist, rng)
            if verbose and start_round:
                print(f"resumed from round {start_round}")
        want_norms = self.coord.wants_update_norms
        clock = hist["wall_clock"][-1] if hist["wall_clock"] else 0.0
        for r in range(start_round, rt.rounds):
            with span("mmfl.allocate"):
                if self.incentive is not None:
                    upd = self.incentive.recruit(RoundContext(
                        round=r, task_names=self.names, losses=self.coord.losses,
                        alpha=spec.allocation.alpha, n_clients=spec.clients.n_clients,
                        eligibility=self.coord.eligibility))
                    if upd is not None:
                        self.coord.eligibility = self._set_eligibility(upd.eligibility)
                alloc = self.coord.next_round()
            t0 = time.time()
            line = []
            row = np.full(spec.clients.n_clients, -1, np.int64)
            norms = np.full(len(self.names), np.nan) if want_norms else None
            round_time = 0.0
            for s, a in enumerate(self.names):
                ids = alloc[a]
                if len(ids) == 0:
                    line.append(f"{a}: -")
                    continue
                row[ids] = s
                if self.population is not None:
                    # cohort-batched latency sampling (same stream order)
                    totals, _ = self.population.sample_latencies(ids, s, 1.0, times=clock)
                    round_time = max(round_time, float(totals.max()))
                else:
                    for i in ids:
                        round_time = max(round_time, self.cost_model.sample_latency(
                            int(i), s, 1.0, time=clock).total)
                loss, norm = self._run_task_round(a, ids, rng, want_norms)
                if want_norms and norm is not None:
                    norms[s] = norm
                self.coord.report(a, loss)
                line.append(f"{a}: {loss:.3f} ({len(ids)}c)")
            self.coord.observe([len(alloc[a]) for a in self.names], norms)
            hist["loss"].append([self.coord.tasks[a].loss for a in self.names])
            hist["counts"].append([len(alloc[a]) for a in self.names])
            hist["alloc"].append(row)
            acc = []
            for a in self.names:
                with span("mmfl.eval"):
                    acc.append(self._eval_acc[a](self.tasks[a]["params"]))
            hist["acc"].append(acc)
            clock += round_time
            hist["wall_clock"].append(clock)
            if ckpt is not None:
                # the round curves stream into the sidecar (buffered; the
                # next save fsyncs it and commits the offset)
                ckpt.append_history({"kind": "round", "loss": list(hist["loss"][-1]),
                                     "counts": list(hist["counts"][-1]), "alloc": row.tolist(),
                                     "acc": list(hist["acc"][-1]), "wall_clock": float(clock)})
            if verbose:
                print(f"round {r + 1:3d} [{time.time() - t0:5.1f}s] " + " | ".join(line))
            if ckpt is not None and (r + 1) % rt.checkpoint_every == 0:
                self._save(ckpt, r + 1, rng)
        if ckpt is not None:
            ckpt.close()
        n = len(hist["loss"])
        counts = np.array(hist["counts"], np.int64).reshape(-1, len(self.names))
        return RunResult(
            scenario=spec.name,
            mode="sync",
            task_names=self.names,
            loss=np.array(hist["loss"]),
            # a resume from a step without them leaves partial accuracy
            # and clock curves: each is reported only when it covers every
            # round
            acc=(np.array(hist["acc"]).reshape(-1, len(self.names))
                 if len(hist["acc"]) == n else None),
            arrivals=counts.sum(axis=0),
            alloc_counts=counts,
            alloc=np.array(hist["alloc"]),
            wall_clock_sim=(np.asarray(hist["wall_clock"], np.float64)
                            if len(hist["wall_clock"]) == n else None),
            spec=spec,
            params=[self.tasks[a]["params"] for a in self.names],
        )


def _require_named_options(spec: ScenarioSpec) -> None:
    """Options make sense only once an entry is named; silently ignoring
    them would hide typos."""
    rt = spec.runtime
    axes = [
        ("runtime", "aggregator", rt.aggregator, rt.aggregator_options, "fedadam"),
        ("runtime", "buffer_controller", rt.buffer_controller,
         rt.buffer_controller_options, "staleness_target"),
        ("runtime", "cost_model", rt.cost_model, rt.cost_model_options, "device_tiers"),
        ("clients", "population", spec.clients.population,
         spec.clients.population_options, "vectorized"),
    ]
    for scope, axis, name, options, example in axes:
        if name is None and options:
            article = "an" if axis[0] in "aeiou" else "a"
            raise ValueError(
                f"{scope}.{axis}_options were given without {article} "
                f"{axis}; name one (e.g. {example!r}) or drop the "
                "options")


def run_scenario(spec: ScenarioSpec, verbose: bool = False, device=None) -> RunResult:
    """Build and run the scenario described by ``spec`` on ``device``
    (``None`` means CUDA; without a card that raises unless the caller
    passes ``device="cpu"``).

    Resolves every registry key up front, so typos fail fast with the
    valid names, runs the optional recruitment auction (round 0 of its
    incentive mechanism) to produce the eligibility matrix, then drives
    the sync or async runtime.
    """
    dev = resolve_device(device)
    # snapshot: the RunResult's provenance record must not change if the
    # caller mutates the spec after the run
    spec = copy.deepcopy(spec)
    family = TASK_FAMILIES.get(spec.family)()
    ALLOCATORS.get(spec.allocation.strategy)
    if spec.policy is not None:
        POLICIES.get(spec.policy.name)
    ARRIVAL_PROCESSES.get(spec.clients.arrival_process)
    BACKENDS.get(spec.runtime.backend)
    if spec.runtime.buffer_controller is not None:
        BUFFER_CONTROLLERS.get(spec.runtime.buffer_controller)
        if spec.runtime.mode == "sync":
            raise ValueError(
                f"buffer_controller {spec.runtime.buffer_controller!r} only applies to "
                "mode='async' (sync rounds have no arrival buffers); drop it or "
                "switch the runtime mode")
    if spec.runtime.aggregator is not None:
        AGGREGATORS.get(spec.runtime.aggregator)
    if spec.runtime.cost_model is not None:
        COST_MODELS.get(spec.runtime.cost_model)
    if spec.clients.population is not None:
        POPULATIONS.get(spec.clients.population)
    _require_named_options(spec)
    auction_summary = None
    eligibility = None
    incentive = None
    if spec.auction is not None:
        if spec.auction.budget <= 0:
            raise ValueError(
                f"auction.budget must be positive, got {spec.auction.budget}: "
                "a non-positive budget recruits no clients (all-False "
                "eligibility matrix), so no task could ever train")
        K, S = spec.clients.n_clients, len(spec.tasks)
        incentive = incentive_from_spec(spec.auction, K, S)
        # prime round 0; a mechanism may defer (return None), and then
        # everyone stays eligible until it first auctions
        upd = incentive.recruit(
            RoundContext(round=0, task_names=[t.name for t in spec.tasks], n_clients=K))
        auction_summary = {"mechanism": spec.auction.mechanism, "budget": spec.auction.budget}
        if upd is not None:
            eligibility = upd.eligibility
            res = upd.result
            if res is not None:
                auction_summary.update({
                    "take_up": res.take_up.tolist(),
                    "min_take_up": res.min_take_up,
                    "diff_take_up": res.diff_take_up,
                    "spent": float(res.spent),
                })
    if spec.runtime.mode == "sync":
        engine = family.sync_engine(spec, eligibility, incentive, dev)
    else:
        engine = family.async_engine(spec, eligibility, incentive, dev)
    t0 = time.time()
    result = engine.run(verbose=verbose)
    result.wall_time = time.time() - t0
    if incentive is not None:
        # the cross-round ledger: what the per-round protocol spent
        auction_summary["incentive"] = spec.auction.incentive
        auction_summary["auctions_run"] = int(incentive.auctions)
        auction_summary["total_spent"] = float(incentive.spent)
    result.auction = auction_summary
    return result
