"""Stateful allocation policies: the legacy strategies of the sync slice.

The port's counterpart of the JAX package's ``api/policy.py``, limited to
what the sync synthetic path runs: the ``RoundContext`` /
``RoundObservation`` data model, the ``AllocationPolicy`` protocol, the
bit-exact ``LegacyStrategyPolicy`` wrapper behind the ``fedfair`` /
``random`` / ``round_robin`` policy keys, ``policy_from_spec`` and
``stacked_delta_norms``. Policies return per-task probabilities and never
consume the caller's RNG stream, so sampling stays in the trainer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.registry import ALLOCATORS, POLICIES
from repro_torch.core.allocation import AllocationStrategy, custom_or_fedfair_probs
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
        if isinstance(strategy, str) and not isinstance(strategy, AllocationStrategy):
            strategy = ALLOCATORS.get(strategy)
        self.strategy = strategy
        self.name = (
            strategy.value
            if isinstance(strategy, AllocationStrategy)
            else getattr(strategy, "__name__", "custom")
        )

    def allocate(self, ctx: RoundContext) -> Optional[np.ndarray]:
        S = len(ctx.task_names)
        if self.strategy == AllocationStrategy.ROUND_ROBIN:
            return None
        finite = np.isfinite(ctx.losses)
        if self.strategy == AllocationStrategy.RANDOM or not finite.any():
            return np.ones(S) / S
        losses = np.where(finite, ctx.losses, np.nanmax(np.where(finite, ctx.losses, np.nan)))
        return custom_or_fedfair_probs(self.strategy, losses, ctx.alpha)


LEGACY_POLICIES = ("fedfair", "random", "round_robin")

# the legacy strategy keys double as policy keys, so PolicySpec("fedfair")
# and the implicit allocation.strategy path resolve to the same wrapper
for _k in LEGACY_POLICIES:
    POLICIES.add(_k, functools.partial(LegacyStrategyPolicy, _k))


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
