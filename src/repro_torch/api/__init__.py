"""The port's scenario API: declarative specs, registries, one entry point.

    from repro_torch.api import ScenarioSpec, TaskSpec, run_scenario

    spec = ScenarioSpec(tasks=[TaskSpec("synth-mnist"),
                               TaskSpec("synth-fmnist")])
    result = run_scenario(spec)              # on the GPU
    result = run_scenario(spec, device="cpu")

``run_scenario`` drives the sync round loop and the async FedAST engine
on the synthetic task family; spec features of later slices raise
``NotImplementedError``. The numpy-only axes (arrival processes, buffer
controllers, cost models) are imported here and register themselves; the
modules that import torch's engines are imported lazily, on first use of
one of their names, so those modules can import this package without a
cycle.
"""

from __future__ import annotations

import importlib

from repro_torch.api.registry import (  # noqa: F401
    AGGREGATORS,
    ALLOCATORS,
    ARRIVAL_PROCESSES,
    BACKENDS,
    BUFFER_CONTROLLERS,
    COST_MODELS,
    POLICIES,
    TASK_FAMILIES,
    Registry,
    register_aggregator,
    register_allocator,
    register_arrival_process,
    register_backend,
    register_buffer_controller,
    register_cost_model,
    register_policy,
    register_task_family,
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
from repro_torch.api.arrivals import (  # noqa: F401
    AlwaysOn,
    ArrivalProcess,
    Bursty,
    PoissonParticipation,
    get_arrival_process,
)
from repro_torch.api.buffer import (  # noqa: F401
    ArrivalRateController,
    BufferController,
    FlushObservation,
    StalenessTargetController,
    get_buffer_controller,
)
from repro_torch.api.costmodel import (  # noqa: F401
    ClientCostModel,
    DeviceTiers,
    LatencySample,
    get_cost_model,
)

_LAZY = {
    "repro_torch.api.engine": ("AsyncEngineRunner", "Engine", "RunResult", "SyncFedEngine",
                               "run_scenario"),
    "repro_torch.api.aggregator": ("Aggregator", "FedAdam", "FedAvg", "FedAvgM", "FedYogi",
                                   "aggregator_from_config", "get_aggregator"),
    "repro_torch.api.backend": ("ClientBatch", "CohortResult", "CohortTask",
                                "ExecutionBackend", "SerialBackend", "VmapBackend",
                                "get_backend"),
}
_LAZY_MODULE = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name: str):
    if name in _LAZY_MODULE:
        return getattr(importlib.import_module(_LAZY_MODULE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_MODULE))
