"""MMFL coordinator: the per-task prevailing losses, the allocation policy,
and the coordinator's own RNG stream.

The port's counterpart of the JAX package's ``core/mmfl.py``, numpy only
and bit-exact with it: the coordinator is a thin stateful shell around an
``AllocationPolicy`` (``repro_torch.api.policy``). The policy gives the
per-task probabilities (Eq. 4 for the default wrapper) and receives
feedback through ``observe``; the coordinator owns the RNG stream (seeded
with ``seed``), the eligibility matrix and the sampling, and the order of
its draws is the contract. The async engine draws each completing
client's next task from ``assign_next``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.policy import (AllocationPolicy, LegacyStrategyPolicy,
                                    RoundContext, RoundObservation)
from repro_torch.core.allocation import AllocationStrategy


@dataclass
class TaskState:
    name: str
    loss: float = float("inf")
    rounds_trained: int = 0
    clients_last_round: int = 0


@dataclass
class MMFLCoordinator:
    task_names: List[str]
    n_clients: int
    alpha: float = 3.0
    strategy: AllocationStrategy = AllocationStrategy.FEDFAIR
    participation: float = 1.0
    seed: int = 0
    eligibility: Optional[np.ndarray] = None      # (K, S) auction outcome
    _round: int = 0
    _async_rr: int = 0
    tasks: Dict[str, TaskState] = field(default_factory=dict)
    # stateful allocation policy; None wraps `strategy`
    policy: Optional[AllocationPolicy] = None
    _obs_count: int = 0

    def __post_init__(self):
        self.tasks = {n: TaskState(n) for n in self.task_names}
        self._rng = np.random.default_rng(self.seed)
        if self.eligibility is None:
            self.eligibility = np.ones((self.n_clients, len(self.task_names)), bool)
        if self.policy is None:
            self.policy = LegacyStrategyPolicy(self.strategy)

    @property
    def losses(self) -> np.ndarray:
        return np.array([max(self.tasks[n].loss, 1e-6) for n in self.task_names])

    @property
    def wants_update_norms(self) -> bool:
        """Engines compute per-task cohort update norms only when the
        policy opts in."""
        return bool(getattr(self.policy, "wants_update_norms", False))

    def report(self, task: str, loss: float):
        self.tasks[task].loss = float(loss)
        self.tasks[task].rounds_trained += 1

    def observe(self, alloc_counts, update_norms=None, task=None):
        """Forward one round's (sync) or one flush's (async) feedback to
        the policy. Never consumes the coordinator RNG stream."""
        self.policy.observe(RoundObservation(
            round=self._obs_count,
            task_names=list(self.task_names),
            losses=self.losses,
            alloc_counts=np.asarray(alloc_counts, np.int64),
            update_norms=(None if update_norms is None
                          else np.asarray(update_norms, np.float64)),
            task=task))
        self._obs_count += 1

    def next_round(self) -> Dict[str, np.ndarray]:
        """Returns task -> array of client ids allocated this round."""
        S = len(self.task_names)
        probs = self._current_probs()
        m = max(1, int(round(self.participation * self.n_clients)))
        active = self._rng.choice(self.n_clients, size=m, replace=False)
        out = {n: [] for n in self.task_names}
        for j, i in enumerate(active):
            elig = self.eligibility[i]
            if not elig.any():
                continue
            if probs is None:                        # round robin
                for off in range(S):
                    s = (self._round + j + off) % S
                    if elig[s]:
                        break
            else:
                pe = probs * elig
                tot = pe.sum()
                if tot <= 0:     # policy zeroed all eligible tasks
                    continue
                s = self._rng.choice(S, p=pe / tot)
            out[self.task_names[s]].append(i)
        self._round += 1
        for n in self.task_names:
            self.tasks[n].clients_last_round = len(out[n])
        return {n: np.array(v, np.int64) for n, v in out.items()}

    def _current_probs(self, client_id=None) -> Optional[np.ndarray]:
        """Per-task allocation probabilities from the policy (None means
        the deterministic round-robin path)."""
        return self.policy.allocate(RoundContext(
            round=self._round,
            task_names=list(self.task_names),
            losses=self.losses,
            alpha=self.alpha,
            n_clients=self.n_clients,
            eligibility=self.eligibility,
            client_id=client_id))

    def assign_next(self, client_id: int) -> Optional[int]:
        """Async allocation: a COMPLETING client immediately draws its next
        task from the policy's distribution on prevailing losses,
        restricted to its eligible tasks. Returns a task index, or None if
        the client is eligible for nothing (it idles out of the pool)."""
        elig = self.eligibility[client_id]
        if not elig.any():
            return None
        S = len(self.task_names)
        probs = self._current_probs(client_id)
        if probs is None:                            # round robin
            for off in range(S):
                s = (self._async_rr + off) % S
                if elig[s]:
                    self._async_rr = (s + 1) % S
                    return s
            return None
        pe = probs * elig
        tot = pe.sum()
        if tot <= 0:             # policy zeroed all eligible tasks
            return None
        return int(self._rng.choice(S, p=pe / tot))

    def state_dict(self) -> Dict:
        """JSON-serializable coordinator state: round counter, RNG stream,
        per-task stats and the policy state."""
        return {
            "round": self._round,
            "async_rr": self._async_rr,
            "obs_count": self._obs_count,
            "rng_state": self._rng.bit_generator.state,
            "policy": self.policy.state_dict(),
            "tasks": {n: {"loss": t.loss,
                          "rounds_trained": t.rounds_trained,
                          "clients_last_round": t.clients_last_round}
                      for n, t in self.tasks.items()},
        }

    def load_state(self, state: Dict):
        """Inverse of ``state_dict``. Tolerates the reference's legacy
        payload ``{"losses": {task: loss}}``, which restores losses only."""
        if "rng_state" not in state:               # legacy format
            for n, loss in state.get("losses", {}).items():
                if n in self.tasks:
                    self.report(n, loss)
            return
        self._round = int(state["round"])
        self._async_rr = int(state["async_rr"])
        self._obs_count = int(state.get("obs_count", 0))
        self._rng.bit_generator.state = state["rng_state"]
        if "policy" in state:
            self.policy.load_state(state["policy"])
        for n, ts in state["tasks"].items():
            if n in self.tasks:
                t = self.tasks[n]
                t.loss = float(ts["loss"])
                t.rounds_trained = int(ts["rounds_trained"])
                t.clients_last_round = int(ts["clients_last_round"])

    def client_weights(self, client_ids: np.ndarray,
                       p_k: Optional[np.ndarray] = None) -> np.ndarray:
        """p_{k,Sel} normalised aggregation weights for the selected
        clients."""
        if p_k is None:
            p_k = np.ones(self.n_clients) / self.n_clients
        w = p_k[client_ids]
        return (w / max(w.sum(), 1e-12)).astype(np.float32)
