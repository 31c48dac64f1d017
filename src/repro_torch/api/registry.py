"""String-keyed extension registries for the port's scenario API.

The same ``Registry`` class as the JAX package's ``api/registry.py``.
It defines the registries of the ported slices: allocators, arrival
processes, auctions, task families, backends, policies, incentives,
buffer controllers, aggregators, cost models and client populations.
This module imports nothing, so built-in
implementations can self-register at import time without cycles.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class Registry:
    """A named string -> object mapping with decorator registration."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        """Decorator: ``@REG.register("key")`` registers the decorated
        object under ``key`` and returns it unchanged."""

        def deco(obj: Any) -> Any:
            if name in self._items and self._items[name] is not obj:
                raise ValueError(f"duplicate {self.kind} registration: {name!r}")
            self._items[name] = obj
            return obj

        return deco

    def add(self, name: str, obj: Any) -> Any:
        """Non-decorator registration (e.g. enum members)."""
        return self.register(name)(obj)

    def get(self, name: str) -> Any:
        """Lookup; unknown keys raise with the list of valid names."""
        try:
            return self._items[name]
        except KeyError:
            valid = ", ".join(self.names()) or "(none)"
            raise KeyError(f"unknown {self.kind} {name!r}; registered: {valid}") from None

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)


ALLOCATORS = Registry("allocator")
ARRIVAL_PROCESSES = Registry("arrival_process")
AUCTIONS = Registry("auction")
TASK_FAMILIES = Registry("task_family")
BACKENDS = Registry("backend")
POLICIES = Registry("policy")
INCENTIVES = Registry("incentive")
BUFFER_CONTROLLERS = Registry("buffer_controller")
AGGREGATORS = Registry("aggregator")
COST_MODELS = Registry("cost_model")
POPULATIONS = Registry("population")

register_allocator = ALLOCATORS.register
register_arrival_process = ARRIVAL_PROCESSES.register
register_auction = AUCTIONS.register
register_task_family = TASK_FAMILIES.register
register_backend = BACKENDS.register
register_policy = POLICIES.register
register_incentive = INCENTIVES.register
register_buffer_controller = BUFFER_CONTROLLERS.register
register_aggregator = AGGREGATORS.register
register_cost_model = COST_MODELS.register
register_population = POPULATIONS.register
