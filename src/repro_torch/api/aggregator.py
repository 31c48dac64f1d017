"""Server-side aggregation rules: the ``fedavg`` fold of the sync slice.

The port's counterpart of the JAX package's ``api/aggregator.py``,
limited to the ``Aggregator`` protocol and the ``fedavg`` rule. The
server optimizers and robust rules come with a later slice.

Contract
--------
Instances are config; per-task server state is held by the engine and
threaded through every call:

    state = agg.init(task_params)            # None for stateless rules
    update, state = agg.aggregate(stacked_deltas, weights, state,
                                  normalizer=None)

``aggregate_params`` is the sync trainer's form (cohorts of ABSOLUTE
client params). The generic rule delta-ises, aggregates and steps; the
``fedavg`` override is the direct weighted mean of the absolute params,
the operation order of the reference trace. The async flush form
(``aggregate_stale``) comes with the async slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.api.registry import AGGREGATORS, register_aggregator
from repro_torch.tree import tree_map


class Aggregator:
    """Server aggregation protocol; see the module docstring."""

    name = "base"
    backend = None  # ExecutionBackend; set by get_aggregator

    def __init__(self):
        self._options: Dict[str, Any] = {}

    def init(self, task_params) -> Optional[Any]:
        """Fresh per-task server state (None for stateless rules)."""
        del task_params
        return None

    def aggregate(self, stacked_deltas, weights, server_state,
                  normalizer=None) -> Tuple[Any, Any]:
        """Fold a stacked cohort of deltas into one params-shaped update.
        Returns ``(update, new_server_state)``."""
        raise NotImplementedError

    def aggregate_params(self, params, stacked_params, weights,
                         server_state, normalizer=None) -> Tuple[Any, Any]:
        """Sync-trainer entry point: cohorts carry ABSOLUTE client params.
        Generic rule: delta-ise against the current globals, aggregate in
        delta space, step. Returns ``(new_params, state)``."""
        deltas = tree_map(lambda c, p: c - p, stacked_params, params)
        update, server_state = self.aggregate(deltas, weights, server_state,
                                              normalizer=normalizer)
        new_params = tree_map(lambda p, u: (p + u).to(p.dtype), params, update)
        return new_params, server_state


@register_aggregator("fedavg")
class FedAvg(Aggregator):
    """Plain weighted mean. Stateless; delegates the reduce to the
    execution backend (the CUDA fedavg kernel under ``vmap`` on a card)."""

    name = "fedavg"

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        agg = self.backend.aggregate(stacked_deltas, weights, normalizer=normalizer)
        return agg, server_state

    def aggregate_params(self, params, stacked_params, weights,
                         server_state, normalizer=None):
        # direct weighted mean of the ABSOLUTE cohort params: equal to the
        # delta form in real arithmetic, and the reference's float trace
        del params
        agg = self.backend.aggregate(stacked_params, weights, normalizer=normalizer)
        return agg, server_state


def get_aggregator(name: str, options: Optional[Dict[str, Any]] = None,
                   backend=None) -> Aggregator:
    """Resolve + construct an aggregator from its registry key; ``backend``
    is the ExecutionBackend the instance delegates weighted reduces to."""
    cls = AGGREGATORS.get(name)
    try:
        agg = cls(**(options or {}))
    except TypeError as e:
        raise ValueError(
            f"aggregator {name!r} rejected options {options!r}: {e}"
        ) from None
    agg.backend = backend
    return agg


def aggregator_from_config(name: Optional[str],
                           options: Optional[Dict[str, Any]],
                           backend=None) -> Aggregator:
    """Engine-side construction: ``None`` selects ``fedavg``; options
    without a name are rejected."""
    if name is None and options:
        raise ValueError(
            "aggregator_options were given without an aggregator; name "
            "one (e.g. 'fedadam') or drop the options")
    return get_aggregator(name or "fedavg", options or {}, backend=backend)
