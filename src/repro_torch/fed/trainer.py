"""End-to-end MMFL simulation loop (paper Algorithm 1 + Section V).

Per global round:
  1. a fraction C of clients is active (uniformly at random);
  2. the allocation policy (FedFairMMFL / random / round-robin) assigns
     each active client to ONE task it is eligible for, renormalising
     Eq. 4 per client over its eligible tasks;
  3. each task's selected clients run tau local SGD steps from the task's
     global params, dispatched through the execution backend
     (``api.backend``: serial reference or one batched cohort call);
  4. the server folds the cohort with p_k weights and re-evaluates test
     accuracy, which feeds the next round's allocation (f_s = 1 - acc_s).

The port's counterpart of the JAX package's ``fed/trainer.py``; host-side
sampling uses the same numpy streams and the device-side randomness the
same threefry keys (``repro_torch.prng``), so a port run follows the
reference's allocation trace. An incentive mechanism
(``api.policy.IncentiveMechanism``) may re-recruit the eligible clients
before each round's allocation. A client population (``repro_torch.pop``)
may own the per-client state, and lazily made shards are gathered per
cohort. With ``checkpoint_dir`` the bounded state is saved every
``checkpoint_every`` rounds (engine kind ``sync_fed``, the reference's
layout) while the round curves stream into the sidecar; ``resume``
continues round for round as an uninterrupted run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.api.aggregator import aggregator_from_config
from repro_torch.api.backend import ClientBatch, CohortTask, get_backend
from repro_torch.api.costmodel import get_cost_model
from repro_torch.api.policy import (AllocationPolicy, LegacyStrategyPolicy,
                                    RoundContext, RoundObservation,
                                    stacked_delta_norms)
from repro_torch.core.allocation import AllocationStrategy
from repro_torch.device import resolve_device
from repro_torch.fed.client import accuracy, cohort_local_update, init_mlp
from repro_torch.fed.data import FedTask
from repro_torch.tree import tree_leaves


def task_round_key(seed: int, task_idx: int, version: int):
    """PRNG key for (task, model version): version is the round index in
    the sync round loop. A cohort update is reproducible from (seed, task,
    version, client_id) alone."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), task_idx), version)


def init_task_model(task: FedTask, key, hidden: int, depth: int,
                    deep_for=(), deep_depth: int = 3, device=None):
    """Model init for ONE task ("bigger model for the harder task", as the
    paper uses a ResNet for CIFAR)."""
    base = task.name.split("#")[0]
    d = deep_depth if base in deep_for else depth
    return init_mlp(key, task.train_x.shape[-1], hidden, task.n_classes,
                    depth=d, device=device)


def init_task_models(tasks: List[FedTask], key, hidden: int, depth: int,
                     deep_for=(), deep_depth: int = 3, device=None):
    """Per-task model init: task s always gets key fold_in(key, s)."""
    return [init_task_model(t, prng.fold_in(key, s), hidden, depth,
                            deep_for, deep_depth, device)
            for s, t in enumerate(tasks)]


def fed_local_fn(tau: int, lr: float, batch_size: int):
    """The cohort update rule behind the ExecutionBackend API: tau local
    SGD steps per client (``fed.client.cohort_local_update``), returning
    ``(stacked_params, losses)``; the losses are zeros, as in the JAX
    package."""

    def local_fn(params, keys, x, y, w):
        updated = cohort_local_update(params, keys, x, y, w, tau, lr, batch_size)
        return updated, torch.zeros(x.shape[0], device=x.device)

    return local_fn


def fed_client_batch(task: FedTask, key, client_ids, device=None) -> ClientBatch:
    """Stacked per-client inputs for a FedTask cohort, on ``device``.
    Per-client keys are ``fold_in(round_key, client_id)`` (on the host:
    they only seed the index draws), so a client's update is independent
    of its cohort. A lazily made task (``pop.data.LazyFedTask``) gathers
    the cohort's rows on the host; only they go to the device."""
    ids = np.asarray(client_ids, np.int64)
    keys = prng.fold_in(key, torch.from_numpy(ids))
    dev = resolve_device(device)
    if hasattr(task, "gather"):
        x, y, w = task.gather(ids)
    else:
        x, y, w = task.train_x[ids], task.train_y[ids], task.train_w[ids]
    return ClientBatch(client_ids=ids, keys=keys,
                       data=tuple(torch.from_numpy(a).to(dev) for a in (x, y, w)))


def cohort_update(global_params, key, task: FedTask, client_ids, tau: int, lr,
                  batch_size: int, device=None):
    """Run tau local steps for the given clients of one task in one batched
    call (library entry point; the legacy async adapters and the tests use
    it as the reference cohort). Returns a cohort with leading axis
    len(client_ids), on ``device`` (None means CUDA). The reference pads
    the cohort to a power of two for its compile cache; fold_in keying
    makes the padded rows duplicates, so the port runs the cohort as it
    is."""
    batch = fed_client_batch(task, key, client_ids, device)
    return cohort_local_update(global_params, batch.keys, *batch.data, tau, lr, batch_size)


@dataclass
class TrainConfig:
    rounds: int = 100
    alpha: float = 3.0
    participation: float = 0.35
    tau: int = 5
    lr: float = 0.1
    batch_size: int = 32
    hidden: int = 64
    depth: int = 2
    strategy: AllocationStrategy = AllocationStrategy.FEDFAIR
    seed: int = 0
    # stragglers: each selected client fails to return its update with
    # this probability and drops out of the round's aggregation
    dropout_prob: float = 0.0
    # "bigger model for the harder task" (paper uses a ResNet for CIFAR)
    deep_for: tuple = ("synth-cifar",)
    deep_depth: int = 3
    # cohort execution backend (api.backend BACKENDS key or instance)
    backend: str = "serial"
    # stateful allocation policy (api.policy); None wraps `strategy`
    policy: Optional[AllocationPolicy] = None
    # server aggregation rule (api.aggregator AGGREGATORS key); None
    # selects "fedavg"
    aggregator: Optional[str] = None
    aggregator_options: dict = field(default_factory=dict)
    # client cost model (api.costmodel COST_MODELS key); None selects
    # "constant". Each round's simulated duration is the max over the
    # cohort's sampled latencies (History.wall_clock_sim).
    cost_model: Optional[str] = None
    cost_model_options: dict = field(default_factory=dict)
    # client population (pop POPULATIONS key); None keeps the per-client
    # state here, "vectorized" is bit-exact with it
    population: Optional[str] = None
    population_options: dict = field(default_factory=dict)
    # mid-run checkpoints (engine kind "sync_fed"): every
    # `checkpoint_every` rounds the bounded state is saved and the round
    # curves stream into the sidecar; resume=True restores the newest
    # complete step, replays the sidecar and continues round for round
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    checkpoint_keep: int = 3
    resume: bool = False


@dataclass
class History:
    acc: np.ndarray                     # (rounds, S)
    alloc_counts: np.ndarray            # (rounds, S)
    alloc: Optional[np.ndarray] = None  # (rounds, K) task id / -1 idle
    # (rounds,) cumulative simulated clock (cost-model round durations)
    wall_clock_sim: Optional[np.ndarray] = None
    min_acc: np.ndarray = field(init=False)
    var_acc: np.ndarray = field(init=False)

    def __post_init__(self):
        self.min_acc = self.acc.min(axis=1)
        self.var_acc = self.acc.var(axis=1)


class MMFLTrainer:
    """The sync round loop. ``device=None`` means CUDA (see
    ``repro_torch.device``); params, cohorts and test sets live there."""

    def __init__(self, tasks: List[FedTask], cfg: TrainConfig,
                 eligibility: Optional[np.ndarray] = None, incentive=None,
                 device=None):
        self.tasks = tasks
        self.cfg = cfg
        self.device = resolve_device(device)
        self.S = len(tasks)
        self.K = tasks[0].n_clients
        if any(t.n_clients != self.K for t in tasks):
            raise ValueError("all tasks must have the same number of clients")
        # eligibility[i, s]: client i willing to train task s (auction
        # winners). Default: everyone trains everything (Section III).
        self.elig = (np.ones((self.K, self.S), bool)
                     if eligibility is None else eligibility.astype(bool))
        self.backend = get_backend(cfg.backend, self.device)
        self._local_fn = fed_local_fn(cfg.tau, cfg.lr, cfg.batch_size)
        self._names = [t.name for t in tasks]
        # allocation dispatches through the policy object; sampling (and
        # the RNG stream) stays here, as in the reference
        self.policy = (cfg.policy if cfg.policy is not None
                       else LegacyStrategyPolicy(cfg.strategy))
        # per-round re-recruitment; one_shot never updates after round 0
        self.incentive = incentive
        self.aggregator = aggregator_from_config(
            cfg.aggregator, cfg.aggregator_options, backend=self.backend)
        # with a population, it OWNS the cost model and the eligibility;
        # the trainer aliases them, so the call sites below are shared
        if cfg.population is None and cfg.population_options:
            raise ValueError(
                "population_options were given without a population; "
                "name one (e.g. 'vectorized') or drop the options")
        self.population = None
        if cfg.population is not None:
            from repro_torch.pop import get_population

            self.population = get_population(
                cfg.population, cfg.population_options, n_clients=self.K, n_tasks=self.S,
                seed=cfg.seed, cost_model=cfg.cost_model,
                cost_model_options=cfg.cost_model_options)
            self.cost_model = self.population.cost_model
            self.elig = self.population.set_eligibility(self.elig)
        else:
            if cfg.cost_model is None and cfg.cost_model_options:
                raise ValueError(
                    "cost_model_options were given without a cost_model; "
                    "name one (e.g. 'device_tiers') or drop the options")
            self.cost_model = get_cost_model(cfg.cost_model or "constant",
                                             cfg.cost_model_options)
        # run() restores these so repeated run() calls are identical
        self._elig0 = self.elig.copy()
        self._policy_state0 = self.policy.state_dict()
        self._incentive_state0 = None if incentive is None else incentive.state_dict()
        self._test = [(torch.from_numpy(t.test_x).to(self.device),
                       torch.from_numpy(t.test_y).to(self.device)) for t in tasks]

    def _init_models(self, key):
        return init_task_models(self.tasks, key, self.cfg.hidden,
                                self.cfg.depth, self.cfg.deep_for,
                                self.cfg.deep_depth, self.device)

    def _set_elig(self, elig) -> np.ndarray:
        """Adopt a (K, S) eligibility matrix, mirroring it into the
        population's struct-of-arrays when there is one."""
        elig = np.asarray(elig, bool)
        if self.population is not None:
            return self.population.set_eligibility(elig)
        return elig

    def _accuracy(self, params, s) -> float:
        x, y = self._test[s]
        return float(accuracy(params, x, y))

    def _allocate(self, rng, losses, round_idx):
        """Per-client task assignment, honouring eligibility. The policy
        supplies the per-task probabilities (None selects round-robin);
        sampling consumes THIS rng, never the policy's."""
        cfg = self.cfg
        m = max(1, int(round(cfg.participation * self.K)))
        active = rng.choice(self.K, size=m, replace=False)
        alloc = -np.ones(self.K, np.int64)      # -1: idle
        p = self.policy.allocate(RoundContext(
            round=round_idx, task_names=self._names, losses=losses,
            alpha=cfg.alpha, n_clients=self.K, eligibility=self.elig))
        if p is None:                           # round robin
            order = rng.permutation(active)
            nxt = round_idx
            for i in order:
                # next task in RR order that i is eligible for
                for off in range(self.S):
                    s = (nxt + off) % self.S
                    if self.elig[i, s]:
                        alloc[i] = s
                        nxt = nxt + off + 1
                        break
            return alloc
        for i in active:
            pe = p * self.elig[i]
            tot = pe.sum()
            if tot <= 0:
                continue
            alloc[i] = rng.choice(self.S, p=pe / tot)
        return alloc

    def run(self, verbose: bool = False) -> History:
        cfg = self.cfg
        self.elig = self._set_elig(self._elig0.copy())
        self.policy.load_state(self._policy_state0)
        if self.incentive is not None:
            self.incentive.load_state(self._incentive_state0)
        rng = np.random.default_rng(cfg.seed)
        params = self._init_models(prng.PRNGKey(cfg.seed))
        server_state = [self.aggregator.init(p) for p in params]
        self.cost_model.reset(
            self.K, self.S, np.random.default_rng(cfg.seed + 3),
            task_sizes=[float(sum(leaf.numel() for leaf in tree_leaves(p)))
                        for p in params])
        clock = 0.0
        accs = np.array([self._accuracy(params[s], s) for s in range(self.S)])
        acc_hist, alloc_hist, assign_hist, clock_hist = [], [], [], []
        need_norms = getattr(self.policy, "wants_update_norms", False)
        ckpt, start_round = None, 0
        if cfg.checkpoint_dir:
            from repro_torch.checkpoint import CheckpointManager, to_device

            if len(set(self._names)) != len(self._names):
                raise ValueError(
                    "checkpointing keys task pytrees by name; rename "
                    f"the duplicated tasks in {self._names!r} (e.g. "
                    "'synth-mnist#1') or drop checkpoint_dir")
            ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep)
            hit = ckpt.begin("sync_fed", cfg.resume)
            if hit is not None:
                coord = hit.coordinator
                for s, t in enumerate(self.tasks):
                    tree = hit.tasks[t.name]
                    params[s] = to_device(tree["params"], self.device)
                    srv = tree.get("server_state")
                    server_state[s] = (to_device(srv, self.device) if srv is not None
                                       else self.aggregator.init(params[s]))
                self.aggregator.load_state(coord["aggregator"])
                self.policy.load_state(coord["policy"])
                self.elig = self._set_elig(np.asarray(coord["eligibility"], bool))
                if self.incentive is not None and "incentive" in coord:
                    self.incentive.load_state(coord["incentive"])
                if self.population is not None and "population" in coord:
                    self.population.validate_config(coord["population"])
                rng.bit_generator.state = coord["rng"]
                self.cost_model.load_state(coord["cost_model"])
                accs = np.asarray(coord["accs"], np.float64)
                clock = float(coord["clock"])
                # the replayed sidecar rebuilds the curves before the step,
                # so the History covers the WHOLE run
                for rec in hit.history or []:
                    if rec.get("kind") != "round":
                        continue
                    acc_hist.append(np.asarray(rec["acc"], np.float64))
                    alloc_hist.append(np.asarray(rec["counts"], np.int64))
                    assign_hist.append(np.asarray(rec["alloc"], np.int64))
                    clock_hist.append(float(rec["wall_clock"]))
                start_round = hit.step
                if verbose:
                    print(f"resumed from round {hit.step}")
        for r in range(start_round, cfg.rounds):
            losses = np.maximum(1.0 - accs, 1e-6)   # paper: use test acc
            if self.incentive is not None:
                upd = self.incentive.recruit(RoundContext(
                    round=r, task_names=self._names, losses=losses,
                    alpha=cfg.alpha, n_clients=self.K, eligibility=self.elig))
                if upd is not None:
                    self.elig = self._set_elig(upd.eligibility)
            alloc = self._allocate(rng, losses, r)
            if cfg.dropout_prob > 0:
                failed = rng.random(self.K) < cfg.dropout_prob
                alloc = np.where(failed, -1, alloc)
            counts = np.array([(alloc == s).sum() for s in range(self.S)])
            norms = np.full(self.S, np.nan) if need_norms else None
            # lockstep barrier: the round costs its slowest sampled
            # (client, task) latency ("constant": unit cost per job)
            round_time = 0.0
            for s, t in enumerate(self.tasks):
                sel_ids = np.where(alloc == s)[0]
                if len(sel_ids) == 0:
                    continue
                if self.population is not None:
                    # cohort-batched latency sampling (same stream order)
                    totals, _ = self.population.sample_latencies(sel_ids, s, 1.0, times=clock)
                    round_time = max(round_time, float(totals.max()))
                else:
                    for i in sel_ids:
                        round_time = max(round_time, self.cost_model.sample_latency(
                            int(i), s, 1.0, time=clock).total)
                res = self.backend.run_cohort(
                    CohortTask(t.name, params[s], self._local_fn),
                    fed_client_batch(t, task_round_key(cfg.seed, s, r), sel_ids,
                                     self.device))
                if need_norms:
                    norms[s] = float(stacked_delta_norms(res.updates, params[s]).mean())
                params[s], server_state[s] = self.aggregator.aggregate_params(
                    params[s], res.updates, torch.from_numpy(t.p_k[sel_ids]),
                    server_state[s])
                accs[s] = self._accuracy(params[s], s)
            self.policy.observe(RoundObservation(
                round=r, task_names=self._names,
                losses=np.maximum(1.0 - accs, 1e-6), alloc_counts=counts,
                update_norms=norms))
            acc_hist.append(accs.copy())
            alloc_hist.append(counts)
            assign_hist.append(alloc.copy())
            clock += round_time
            clock_hist.append(clock)
            if ckpt is not None:
                # the round curves stream into the sidecar (buffered; the
                # next save fsyncs it and commits the offset)
                ckpt.append_history({
                    "kind": "round",
                    "acc": [float(a) for a in accs],
                    "counts": [int(c) for c in counts],
                    "alloc": [int(x) for x in alloc],
                    "wall_clock": float(clock),
                })
                if cfg.checkpoint_every > 0 and (r + 1) % cfg.checkpoint_every == 0:
                    self._save(ckpt, r + 1, params, server_state, rng, accs, clock)
            if verbose and (r + 1) % 10 == 0:
                print(f"  round {r+1:4d} accs="
                      + " ".join(f"{a:.3f}" for a in accs)
                      + f" min={accs.min():.3f}")
        if ckpt is not None:
            ckpt.close()
        self.params = params    # final per-task models (RunResult parity)
        return History(np.array(acc_hist), np.array(alloc_hist),
                       alloc=np.array(assign_hist),
                       wall_clock_sim=np.asarray(clock_hist, np.float64))

    def _save(self, ckpt, step, params, server_state, rng, accs, clock) -> None:
        """One checkpoint step: per-task ``params`` (and ``server_state``
        for a stateful aggregator) as pytrees, the rest as the JSON
        coordinator payload, in the reference's layout."""
        trees = {}
        for s, t in enumerate(self.tasks):
            trees[t.name] = {"params": params[s]}
            if server_state[s] is not None:
                trees[t.name]["server_state"] = server_state[s]
        coord = {
            "policy": self.policy.state_dict(),
            "eligibility": np.asarray(self.elig, bool).tolist(),
            "rng": rng.bit_generator.state,
            "accs": [float(a) for a in accs],
            "clock": float(clock),
            "aggregator": self.aggregator.state_dict(),
            "cost_model": self.cost_model.state_dict(),
        }
        if self.population is not None:
            coord["population"] = self.population.config_record()
        if self.incentive is not None:
            coord["incentive"] = self.incentive.state_dict()
        ckpt.save(step, trees, coordinator_state=coord, engine_kind="sync_fed")
