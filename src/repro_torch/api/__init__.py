"""The port's scenario API: declarative specs, registries, one entry point.

    from repro_torch.api import ScenarioSpec, TaskSpec, run_scenario

    spec = ScenarioSpec(tasks=[TaskSpec("synth-mnist"),
                               TaskSpec("synth-fmnist")])
    result = run_scenario(spec)              # on the GPU
    result = run_scenario(spec, device="cpu")

``run_scenario`` drives the sync round loop and the async FedAST engine
on the synthetic task family and on the ``arch`` family (LM training:
the four dense configs and zamba2-7b), with the recruitment auctions and their
incentive mechanisms, the stateful policies, every aggregator and every
cost model, client populations (``vectorized``, with lazily made shards)
and mid-run checkpoints with resume; ``sweep_scenarios`` runs a grid of
spec overrides, on the ``serial``, ``vmap`` and ``sharded`` backends.
The numpy-only axes (arrival processes, buffer controllers, cost models,
policies, incentives, auctions and populations) are imported here and
register themselves; the
engines, aggregators, backends and the sweep are imported lazily, on
first use of one of their names, so those modules can import this
package without a cycle.
"""

from __future__ import annotations

import importlib

from repro_torch.api.registry import (  # noqa: F401
    AGGREGATORS,
    ALLOCATORS,
    ARRIVAL_PROCESSES,
    AUCTIONS,
    BACKENDS,
    BUFFER_CONTROLLERS,
    COST_MODELS,
    INCENTIVES,
    POLICIES,
    POPULATIONS,
    Registry,
    register_aggregator,
    register_allocator,
    register_arrival_process,
    register_auction,
    register_backend,
    register_buffer_controller,
    register_cost_model,
    register_incentive,
    register_policy,
    register_population,
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
    LognormalStraggler,
    TraceReplay,
    get_cost_model,
)
from repro_torch.api.policy import (  # noqa: F401  (registers the policies, incentives, auctions)
    AllocationPolicy,
    EligibilityUpdate,
    GradNormPolicy,
    IncentiveMechanism,
    LegacyStrategyPolicy,
    OneShotAuction,
    PeriodicAuction,
    RoundContext,
    RoundObservation,
    ThompsonPolicy,
    UCBBanditPolicy,
    build_eligibility,
    incentive_from_spec,
    policy_from_spec,
)
from repro_torch.pop import (  # noqa: F401  (registers the "vectorized" population)
    ClientPopulation,
    LazyFedTask,
    VectorizedPopulation,
    get_population,
)

_LAZY = {
    # TASK_FAMILIES lives in api.registry, but engine.py registers its
    # entries: reaching it through the engine keeps the families populated
    "repro_torch.api.engine": ("ArchFamily", "ArchSyncEngine", "AsyncEngineRunner", "Engine",
                               "RunResult", "SyncFedEngine", "TASK_FAMILIES", "run_scenario"),
    "repro_torch.api.aggregator": ("Aggregator", "FedAdam", "FedAvg", "FedAvgM", "FedMedian",
                                   "FedYogi", "QFedAvg", "TrimmedMean",
                                   "aggregator_from_config", "get_aggregator"),
    "repro_torch.api.sweep": ("apply_override", "sweep_scenarios"),
    "repro_torch.api.backend": ("ClientBatch", "CohortResult", "CohortTask",
                                "ExecutionBackend", "SerialBackend", "ShardedBackend",
                                "VmapBackend", "get_backend"),
}
_LAZY_MODULE = {name: mod for mod, names in _LAZY.items() for name in names}


def __getattr__(name: str):
    if name in _LAZY_MODULE:
        return getattr(importlib.import_module(_LAZY_MODULE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_MODULE))
