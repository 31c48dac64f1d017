"""The port's scenario API: declarative specs, registries, one entry point.

    from repro_torch.api import ScenarioSpec, TaskSpec, run_scenario

    spec = ScenarioSpec(tasks=[TaskSpec("synth-mnist"),
                               TaskSpec("synth-fmnist")])
    result = run_scenario(spec)              # on the GPU
    result = run_scenario(spec, device="cpu")

``run_scenario`` drives the sync round loop on the synthetic task family;
spec features of later slices raise ``NotImplementedError``. The engine
is imported lazily, so the numpy-only modules (which register into the
registries here) can import this package without a cycle.
"""

from __future__ import annotations

from repro_torch.api.registry import (  # noqa: F401
    AGGREGATORS,
    ALLOCATORS,
    BACKENDS,
    COST_MODELS,
    POLICIES,
    TASK_FAMILIES,
    Registry,
)
from repro_torch.api.spec import (  # noqa: F401
    AllocationSpec,
    AuctionSpec,
    ClientPopulationSpec,
    PolicySpec,
    RuntimeSpec,
    ScenarioSpec,
    TaskSpec,
)

_ENGINE_EXPORTS = ("Engine", "RunResult", "SyncFedEngine", "run_scenario")


def __getattr__(name: str):
    if name in _ENGINE_EXPORTS:
        from repro_torch.api import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_ENGINE_EXPORTS))
