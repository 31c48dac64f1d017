"""Stateful allocation policies and incentive mechanisms.

The port's counterpart of the JAX package's ``api/policy.py``, numpy only
and bit-exact with it:

``AllocationPolicy``
    ``observe(RoundObservation)`` takes per-round feedback (losses,
    allocation counts, optional cohort update norms); ``allocate(RoundContext)``
    returns the per-task probability vector (``None`` selects the callers'
    round-robin path). Policies never consume the caller's RNG stream.
    The legacy strategies (``fedfair`` / ``random`` / ``round_robin``)
    through ``LegacyStrategyPolicy``; ``ucb_bandit``, ``thompson`` (its own
    seeded generator) and ``grad_norm`` (``wants_update_norms``).

``IncentiveMechanism``
    ``recruit(RoundContext) -> EligibilityUpdate | None`` may re-run the
    recruitment auction (``core/auctions.py``) on any round against a
    cross-round budget ledger: ``one_shot`` auctions once, at the first
    call; ``periodic_auction`` every ``every`` rounds with the remaining
    budget and fresh bids, recruiting cumulatively.

``state_dict``/``load_state`` are JSON-native full restores; the trainer
loads the construction-time state at the start of ``run()``.

This module imports nothing of ``repro_torch.core`` at module level:
``core.allocation`` and ``core.auctions`` import ``api.registry``, which
runs this package's ``__init__``. ``LegacyStrategyPolicy`` imports them
when it runs, and ``api/__init__.py`` imports them to register their
entries.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.registry import (ALLOCATORS, AUCTIONS, INCENTIVES, POLICIES,
                                      register_incentive, register_policy)
from repro_torch.tree import tree_leaves


@dataclass
class RoundContext:
    """What a policy sees when asked to act for one round. ``losses`` is
    the prevailing f_s vector (may contain inf for never-reported
    tasks)."""

    round: int
    task_names: List[str]
    losses: Optional[np.ndarray] = None
    alpha: float = 3.0
    n_clients: int = 0
    eligibility: Optional[np.ndarray] = None
    client_id: Optional[int] = None


@dataclass
class RoundObservation:
    """Per-round feedback fed to ``AllocationPolicy.observe``: post-round
    losses, per-task allocation counts, and (when the policy sets
    ``wants_update_norms``) the mean l2 norm of the round's client updates
    per task."""

    round: int
    task_names: List[str]
    losses: np.ndarray
    alloc_counts: np.ndarray
    update_norms: Optional[np.ndarray] = None
    task: Optional[int] = None


@dataclass
class EligibilityUpdate:
    """One recruitment outcome: the FULL new (K, S) eligibility matrix,
    the raw auction result, and what this auction spent from the ledger."""

    eligibility: np.ndarray
    result: Any = None
    spent: float = 0.0
    round: int = 0


class AllocationPolicy:
    """Stateful client-task allocation protocol.

    ``allocate`` returns the (S,) per-task probability vector the caller
    samples from (renormalised per client over its eligible tasks), or
    ``None`` to select the caller's deterministic round-robin path.
    ``load_state(state_dict())`` must be a full restore: ``MMFLTrainer.run``
    loads the construction-time state so repeated runs are reproducible.
    """

    name = "policy"
    # engines compute per-task cohort update norms (an extra reduction on
    # the hot path) only when a policy opts in
    wants_update_norms = False

    def observe(self, obs: RoundObservation) -> None:
        del obs

    def allocate(self, ctx: RoundContext) -> Optional[np.ndarray]:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state(self, state: Dict[str, Any]) -> None:
        del state


class LegacyStrategyPolicy(AllocationPolicy):
    """Stateless wrapper for an ``AllocationStrategy`` member, an
    ALLOCATORS registry key, or any custom ``(losses, alpha) -> probs``
    callable, with the reference's unreported-loss fallbacks."""

    def __init__(self, strategy="fedfair"):
        from repro_torch.core.allocation import AllocationStrategy

        if isinstance(strategy, str) and not isinstance(strategy, AllocationStrategy):
            strategy = ALLOCATORS.get(strategy)
        self.strategy = strategy
        self.name = (
            strategy.value
            if isinstance(strategy, AllocationStrategy)
            else getattr(strategy, "__name__", "custom")
        )

    def allocate(self, ctx: RoundContext) -> Optional[np.ndarray]:
        from repro_torch.core.allocation import AllocationStrategy, custom_or_fedfair_probs

        S = len(ctx.task_names)
        if self.strategy == AllocationStrategy.ROUND_ROBIN:
            return None
        finite = np.isfinite(ctx.losses)
        if self.strategy == AllocationStrategy.RANDOM or not finite.any():
            return np.ones(S) / S
        losses = np.where(finite, ctx.losses, np.nanmax(np.where(finite, ctx.losses, np.nan)))
        return custom_or_fedfair_probs(self.strategy, losses, ctx.alpha)


# the legacy strategy keys double as policy keys, so PolicySpec("fedfair")
# and the implicit allocation.strategy path resolve to the same wrapper
for _k in ("fedfair", "random", "round_robin"):
    POLICIES.add(_k, functools.partial(LegacyStrategyPolicy, _k))


@register_policy("ucb_bandit")
class UCBBanditPolicy(AllocationPolicy):
    """UCB1 task selection on per-task loss-delta rewards (bandit-style
    task picking in the spirit of Multi-Model FL with Provable Guarantees,
    arXiv:2207.04330). Each observed round, every task that received
    clients yields reward ``previous_loss - new_loss``; allocation puts
    ``1 - epsilon`` mass on the UCB-argmax task and spreads ``epsilon``
    uniformly (so no task starves and every task keeps reporting)."""

    name = "ucb_bandit"

    def __init__(self, c: float = 1.0, epsilon: float = 0.1):
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"ucb_bandit: epsilon must be in [0, 1], got {epsilon}")
        self.c = float(c)
        self.epsilon = float(epsilon)
        self.t = 0
        self.counts: Optional[np.ndarray] = None
        self.means: Optional[np.ndarray] = None
        self.last_loss: Optional[np.ndarray] = None

    def _ensure(self, S: int) -> None:
        if self.counts is None:
            self.counts = np.zeros(S, np.int64)
            self.means = np.zeros(S)
            self.last_loss = np.full(S, np.nan)
        elif len(self.counts) != S:
            raise ValueError(f"ucb_bandit: task count changed ({len(self.counts)} -> {S})")

    def observe(self, obs: RoundObservation) -> None:
        S = len(obs.task_names)
        self._ensure(S)
        self.t += 1
        losses = np.asarray(obs.losses, np.float64)
        for s in np.where(np.asarray(obs.alloc_counts) > 0)[0]:
            if np.isfinite(self.last_loss[s]) and np.isfinite(losses[s]):
                reward = float(self.last_loss[s] - losses[s])
                self.counts[s] += 1
                self.means[s] += (reward - self.means[s]) / self.counts[s]
        finite = np.isfinite(losses)
        self.last_loss[finite] = losses[finite]

    def allocate(self, ctx: RoundContext) -> np.ndarray:
        S = len(ctx.task_names)
        self._ensure(S)
        if (self.counts == 0).any():
            best = int(np.argmin(self.counts))  # play never-rewarded tasks first
        else:
            bonus = self.c * np.sqrt(np.log(self.t + 1.0) / self.counts)
            best = int(np.argmax(self.means + bonus))
        probs = np.full(S, self.epsilon / S)
        probs[best] += 1.0 - self.epsilon
        return probs

    def state_dict(self) -> Dict[str, Any]:
        if self.counts is None:
            return {"t": self.t}
        return {
            "t": self.t,
            "counts": self.counts.tolist(),
            "means": self.means.tolist(),
            # None (not NaN) for never-seen losses: the state stays valid JSON
            "last_loss": [float(v) if np.isfinite(v) else None for v in self.last_loss],
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.t = int(state.get("t", 0))
        if "counts" in state:
            self.counts = np.asarray(state["counts"], np.int64)
            self.means = np.asarray(state["means"], np.float64)
            self.last_loss = np.array(
                [np.nan if v is None else float(v) for v in state["last_loss"]]
            )
        else:
            # the state of a never-observed policy: loading it is a reset
            self.counts = self.means = self.last_loss = None


@register_policy("thompson")
class ThompsonPolicy(AllocationPolicy):
    """Thompson sampling on per-task loss-delta rewards (the Bayesian
    sibling of ``ucb_bandit``): each task's reward posterior is modelled
    as Normal(mean, scale^2 / (count + 1)); every allocation draws one
    sample per task and puts ``1 - epsilon`` mass on the argmax,
    spreading ``epsilon`` uniformly so no task starves. Draws come from
    the policy's OWN seeded generator, whose state is part of
    ``state_dict`` (``rng_state``), so a restored policy samples the same
    posterior sequence."""

    name = "thompson"

    def __init__(self, scale: float = 0.05, epsilon: float = 0.1,
                 seed: int = 0):
        if scale <= 0:
            raise ValueError(f"thompson: scale must be > 0, got {scale}")
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(
                f"thompson: epsilon must be in [0, 1], got {epsilon}")
        self.scale = float(scale)
        self.epsilon = float(epsilon)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.counts: Optional[np.ndarray] = None
        self.means: Optional[np.ndarray] = None
        self.last_loss: Optional[np.ndarray] = None

    def _ensure(self, S: int) -> None:
        if self.counts is None:
            self.counts = np.zeros(S, np.int64)
            self.means = np.zeros(S)
            self.last_loss = np.full(S, np.nan)
        elif len(self.counts) != S:
            raise ValueError(
                f"thompson: task count changed ({len(self.counts)} -> {S})")

    def observe(self, obs: RoundObservation) -> None:
        self._ensure(len(obs.task_names))
        losses = np.asarray(obs.losses, np.float64)
        for s in np.where(np.asarray(obs.alloc_counts) > 0)[0]:
            if np.isfinite(self.last_loss[s]) and np.isfinite(losses[s]):
                reward = float(self.last_loss[s] - losses[s])
                self.counts[s] += 1
                self.means[s] += (reward - self.means[s]) / self.counts[s]
        finite = np.isfinite(losses)
        self.last_loss[finite] = losses[finite]

    def allocate(self, ctx: RoundContext) -> np.ndarray:
        S = len(ctx.task_names)
        self._ensure(S)
        draws = self.rng.normal(self.means,
                                self.scale / np.sqrt(self.counts + 1.0))
        probs = np.full(S, self.epsilon / S)
        probs[int(np.argmax(draws))] += 1.0 - self.epsilon
        return probs

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"rng_state": self.rng.bit_generator.state}
        if self.counts is not None:
            state.update({
                "counts": self.counts.tolist(),
                "means": self.means.tolist(),
                "last_loss": [float(v) if np.isfinite(v) else None
                              for v in self.last_loss],
            })
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        self.rng = np.random.default_rng(self.seed)
        if "rng_state" in state:
            self.rng.bit_generator.state = state["rng_state"]
        if "counts" in state:
            self.counts = np.asarray(state["counts"], np.int64)
            self.means = np.asarray(state["means"], np.float64)
            self.last_loss = np.array(
                [np.nan if v is None else float(v)
                 for v in state["last_loss"]])
        else:
            # the state of a never-observed policy: loading it is a reset
            self.counts = self.means = self.last_loss = None


@register_policy("grad_norm")
class GradNormPolicy(AllocationPolicy):
    """Allocation ∝ an EMA of each task's observed mean client-update norm
    (heterogeneity-aware sampling in the spirit of arXiv:2504.05138):
    tasks whose cohorts still move far from the global model get more
    clients. Norms are fed from the backend's ``CohortResult`` by the
    engines (``wants_update_norms``); before any observation the policy
    is uniform, and never-observed tasks get the mean seen norm so they
    are explored rather than starved."""

    name = "grad_norm"
    wants_update_norms = True

    def __init__(self, gamma: float = 0.5, floor: float = 0.1):
        if not 0.0 < gamma <= 1.0:
            raise ValueError(f"grad_norm: gamma must be in (0, 1], got {gamma}")
        if floor < 0.0:
            raise ValueError(f"grad_norm: floor must be >= 0, got {floor}")
        self.gamma = float(gamma)
        self.floor = float(floor)
        self.ema: Optional[np.ndarray] = None

    def _ensure(self, S: int) -> None:
        if self.ema is None:
            self.ema = np.full(S, np.nan)
        elif len(self.ema) != S:
            raise ValueError(f"grad_norm: task count changed ({len(self.ema)} -> {S})")

    def observe(self, obs: RoundObservation) -> None:
        if obs.update_norms is None:
            return
        self._ensure(len(obs.task_names))
        norms = np.asarray(obs.update_norms, np.float64)
        for s in np.where(np.isfinite(norms))[0]:
            if np.isfinite(self.ema[s]):
                self.ema[s] = (1.0 - self.gamma) * self.ema[s] + self.gamma * norms[s]
            else:
                self.ema[s] = norms[s]

    def allocate(self, ctx: RoundContext) -> np.ndarray:
        S = len(ctx.task_names)
        self._ensure(S)
        seen = np.isfinite(self.ema)
        if not seen.any():
            return np.ones(S) / S
        base = np.where(seen, self.ema, float(self.ema[seen].mean()))
        base = base + self.floor * max(float(base.max()), 1e-12)
        return base / base.sum()

    def state_dict(self) -> Dict[str, Any]:
        if self.ema is None:
            return {}
        return {"ema": [float(v) if np.isfinite(v) else None for v in self.ema]}

    def load_state(self, state: Dict[str, Any]) -> None:
        if "ema" in state:
            self.ema = np.array([np.nan if v is None else float(v) for v in state["ema"]])
        else:
            self.ema = None  # the state of a never-observed policy: reset


def policy_from_spec(policy_spec, strategy="fedfair") -> AllocationPolicy:
    """Resolve the allocation policy for one run: an explicit ``PolicySpec``
    wins; otherwise the ``allocation.strategy`` key maps onto its wrapper.
    Always returns a fresh instance."""
    if policy_spec is not None:
        factory = POLICIES.get(policy_spec.name)
        return factory(**dict(policy_spec.options))
    return LegacyStrategyPolicy(strategy)


def stacked_delta_norms(stacked, base=None) -> np.ndarray:
    """Per-row l2 norms (float64) of a stacked cohort pytree (leading axis
    = cohort size). With ``base`` (an unstacked pytree of the same
    structure) the norms are of ``row - base``: each client's update
    displacement from the global params."""
    sq = None
    base_leaves = None if base is None else tree_leaves(base)
    for i, leaf in enumerate(tree_leaves(stacked)):
        a = leaf.detach().to(torch.float64)
        if base_leaves is not None:
            a = a - base_leaves[i].detach().to(torch.float64)[None]
        s = (a.reshape(a.shape[0], -1) ** 2).sum(dim=1)
        sq = s if sq is None else sq + s
    return np.zeros(0) if sq is None else np.sqrt(sq.cpu().numpy())


# ------------------------------------------------------- recruitment / bids

BID_MODELS = {
    # bids ~ U(0, 1) iid per (user, task)
    "uniform": lambda rng, n, S: rng.random((n, S)),
}


def _bids_exp4(rng, n, S):
    """Experiment 4's bid model: task 1 truncated Gaussian, task 2
    increasing-linear density on [0, 1] (2 tasks only)."""
    if S != 2:
        raise ValueError(f"bid model 'exp4' is defined for 2 tasks, got {S}")
    b = np.empty((n, 2))
    b[:, 0] = np.clip(rng.normal(0.5, 0.2, n), 0.01, 1.0)
    b[:, 1] = np.sqrt(rng.random(n))
    return b


BID_MODELS["exp4"] = _bids_exp4


def draw_bids(auction, n_clients: int, n_tasks: int, seed_offset: int = 0) -> np.ndarray:
    """One vectorized bid matrix (K, S) for an ``AuctionSpec``: explicit
    ``bids`` verbatim, otherwise the named bid model on its own Generator
    (``bid_seed + seed_offset``)."""
    if auction.bids is not None:
        bids = np.asarray(auction.bids, np.float64)
        if bids.shape != (n_clients, n_tasks):
            raise ValueError(f"explicit bids shape {bids.shape} != ({n_clients}, {n_tasks})")
        return bids
    try:
        model = BID_MODELS[auction.bid_model]
    except KeyError:
        known = ", ".join(sorted(BID_MODELS))
        raise KeyError(f"unknown bid model {auction.bid_model!r}; known: {known}") from None
    return model(np.random.default_rng(auction.bid_seed + seed_offset), n_clients, n_tasks)


def build_eligibility(auction, n_clients: int, n_tasks: int, budget=None, seed_offset: int = 0):
    """Run the named auction; returns (eligibility (K, S) bool, result).

    ``budget``/``seed_offset`` let per-round incentive mechanisms
    re-auction against a remaining-budget ledger with fresh bid draws; the
    defaults reproduce the legacy one-shot round-0 call bit-exactly.
    """
    bids = draw_bids(auction, n_clients, n_tasks, seed_offset)
    mech = AUCTIONS.get(auction.mechanism)
    res = mech(
        bids,
        auction.budget if budget is None else budget,
        rng=np.random.default_rng(auction.bid_seed + seed_offset + 1),
        **auction.options,
    )
    # per-task winner scatter (vectorized; winners lists stay ragged)
    elig = np.zeros((n_clients, n_tasks), bool)
    for s, ws in enumerate(res.winners):
        if len(ws):
            elig[np.asarray(ws, np.int64), s] = True
    return elig, res


# ---------------------------------------------------------------- incentives


class IncentiveMechanism:
    """Per-round client-recruitment protocol with a cross-round budget
    ledger. Engines call ``recruit(ctx)`` every round (async engines:
    every flush, so ``ctx.round`` is the 1-based flush count there; the
    round-0 call comes from ``run_scenario``'s priming, where
    ``ctx.losses`` is None because no task has trained yet). A mechanism
    returns an ``EligibilityUpdate`` when it re-auctions and ``None``
    otherwise — including from the very first call, which leaves everyone
    eligible until it does auction. ``spent``/``auctions`` track the
    cumulative ledger; ``state_dict`` (JSON-native, embeds the current
    eligibility matrix) restores it budget- and recruitment-exact (the
    sync trainer reloads the construction-time state at each ``run()``).

    Subclasses implement ``_recruit``; the public ``recruit`` is an
    idempotence guard — callers may ask more than once for the same round
    index (``run_scenario`` primes round 0 before a sync engine's own
    round-0 call), and only the first call per round reaches
    ``_recruit``, so a mechanism keyed on ``ctx.round`` (e.g.
    ``round % every == 0``) can never double-auction a round."""

    name = "incentive"

    def __init__(self):
        self.spent = 0.0
        self.auctions = 0
        self.eligibility: Optional[np.ndarray] = None
        self.spec = None
        self.n_clients = 0
        self.n_tasks = 0
        self._last_round: Optional[int] = None

    def reset(self, n_clients: int, n_tasks: int, auction_spec) -> None:
        self.n_clients = int(n_clients)
        self.n_tasks = int(n_tasks)
        self.spec = auction_spec
        self.spent = 0.0
        self.auctions = 0
        self.eligibility = None
        self._last_round = None

    def recruit(self, ctx: RoundContext) -> Optional[EligibilityUpdate]:
        if self._last_round is not None and ctx.round <= self._last_round:
            return None
        self._last_round = ctx.round
        return self._recruit(ctx)

    def _recruit(self, ctx: RoundContext) -> Optional[EligibilityUpdate]:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {
            "spent": float(self.spent),
            "auctions": int(self.auctions),
            "last_round": self._last_round,
            "eligibility": (
                None if self.eligibility is None else np.asarray(self.eligibility, bool).tolist()
            ),
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        self.spent = float(state.get("spent", 0.0))
        self.auctions = int(state.get("auctions", 0))
        last = state.get("last_round")
        self._last_round = None if last is None else int(last)
        elig = state.get("eligibility")
        self.eligibility = None if elig is None else np.asarray(elig, bool)


@register_incentive("one_shot")
class OneShotAuction(IncentiveMechanism):
    """Legacy semantics, bit-exact: the recruitment auction runs once (the
    first ``recruit`` call — round 0 via ``run_scenario``) and the
    eligibility matrix is fixed for the rest of the run."""

    name = "one_shot"

    def _recruit(self, ctx: RoundContext) -> Optional[EligibilityUpdate]:
        if self.auctions > 0:
            return None
        elig, res = build_eligibility(self.spec, self.n_clients, self.n_tasks)
        self.auctions = 1
        self.spent = float(res.spent)
        self.eligibility = elig
        return EligibilityUpdate(elig, res, float(res.spent), ctx.round)


@register_incentive("periodic_auction")
class PeriodicAuction(IncentiveMechanism):
    """Re-run the named auction every ``every`` rounds against the
    REMAINING budget (``AuctionSpec.budget`` minus the ledger). Each
    re-auction draws fresh bids (``resample_bids``; seeded from
    ``bid_seed`` plus a deterministic per-auction offset, so resume needs
    only the counters) and recruitment is cumulative: clients already
    paid stay eligible, new winners are unioned in. Auction 0 is
    bit-identical to ``one_shot``."""

    name = "periodic_auction"

    def __init__(self, every: int = 10, resample_bids: bool = True):
        super().__init__()
        if int(every) < 1:
            raise ValueError(f"periodic_auction: every must be >= 1, got {every}")
        self.every = int(every)
        self.resample_bids = bool(resample_bids)
        self.next_due = 0

    def reset(self, n_clients: int, n_tasks: int, auction_spec) -> None:
        super().reset(n_clients, n_tasks, auction_spec)
        self.next_due = 0

    def _recruit(self, ctx: RoundContext) -> Optional[EligibilityUpdate]:
        if ctx.round < self.next_due:
            return None
        remaining = float(self.spec.budget) - self.spent
        if self.auctions > 0 and remaining <= 1e-9:
            self.next_due = ctx.round + self.every  # ledger exhausted: skip
            return None
        offset = 7919 * self.auctions if self.resample_bids else 0
        elig, res = build_eligibility(
            self.spec, self.n_clients, self.n_tasks, budget=remaining, seed_offset=offset
        )
        if self.eligibility is not None:
            elig = elig | np.asarray(self.eligibility, bool)
        self.auctions += 1
        self.spent += float(res.spent)
        self.eligibility = elig
        self.next_due = ctx.round + self.every
        return EligibilityUpdate(elig, res, float(res.spent), ctx.round)

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["next_due"] = int(self.next_due)
        return state

    def load_state(self, state: Dict[str, Any]) -> None:
        super().load_state(state)
        self.next_due = int(state.get("next_due", 0))


def incentive_from_spec(auction_spec, n_clients: int, n_tasks: int) -> IncentiveMechanism:
    """Build and reset the incentive mechanism named by
    ``AuctionSpec.incentive`` (fresh instance per run)."""
    factory = INCENTIVES.get(auction_spec.incentive)
    inc = factory(**dict(auction_spec.incentive_options))
    inc.reset(n_clients, n_tasks, auction_spec)
    return inc
