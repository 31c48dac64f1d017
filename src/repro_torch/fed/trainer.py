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
before each round's allocation. Checkpointing and client populations come
with later slices.
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
    """Stacked per-client inputs for a FedTask cohort. Per-client keys are
    ``fold_in(round_key, client_id)`` (on the host: they only seed the
    index draws), so a client's update is independent of its cohort."""
    ids = np.asarray(client_ids, np.int64)
    keys = prng.fold_in(key, torch.from_numpy(ids))
    dev = resolve_device(device)
    return ClientBatch(
        client_ids=ids,
        keys=keys,
        data=(torch.from_numpy(task.train_x[ids]).to(dev),
              torch.from_numpy(task.train_y[ids]).to(dev),
              torch.from_numpy(task.train_w[ids]).to(dev)))


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
        self.elig = self._elig0.copy()
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
        for r in range(cfg.rounds):
            losses = np.maximum(1.0 - accs, 1e-6)   # paper: use test acc
            if self.incentive is not None:
                upd = self.incentive.recruit(RoundContext(
                    round=r, task_names=self._names, losses=losses,
                    alpha=cfg.alpha, n_clients=self.K, eligibility=self.elig))
                if upd is not None:
                    self.elig = np.asarray(upd.eligibility, bool)
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
            if verbose and (r + 1) % 10 == 0:
                print(f"  round {r+1:4d} accs="
                      + " ".join(f"{a:.3f}" for a in accs)
                      + f" min={accs.min():.3f}")
        self.params = params    # final per-task models (RunResult parity)
        return History(np.array(acc_hist), np.array(alloc_hist),
                       alloc=np.array(assign_hist),
                       wall_clock_sim=np.asarray(clock_hist, np.float64))
