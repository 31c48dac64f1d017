"""Grid sweeps over ScenarioSpecs: one call, one merged RunResult JSON.

The port's counterpart of the JAX package's ``api/sweep.py``. A sweep is
a base spec plus a grid of dotted-path overrides, e.g.
``{"runtime.aggregator": ["fedmedian", "qfedavg"], "allocation.alpha":
[1.0, 3.0]}``; every point of the cartesian product runs through
``run_scenario`` on ``device`` and the ``RunResult.to_json()`` payloads
are merged in grid order:

    from repro_torch.api import sweep_scenarios
    merged = sweep_scenarios(base, {"runtime.aggregator": ["fedmedian", "qfedavg"]},
                             device="cuda", max_workers=2)

``max_workers=N`` runs the points in N worker processes of a
spawn-context ``ProcessPoolExecutor`` (a forked child cannot use CUDA);
each worker rebuilds its spec from JSON and opens its own CUDA context
on the device. ``runs`` keeps grid order either way, so sequential and
parallel payloads are interchangeable. Grid points may only name
registry keys importable from ``repro_torch``.
"""

from __future__ import annotations

import copy
import json
import time
from itertools import product
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.api.spec import ScenarioSpec


def apply_override(spec: ScenarioSpec, path: str, value: Any) -> None:
    """Set a dotted-path field on a spec tree (``runtime.backend``,
    ``allocation.alpha``, ``seed``, ...), failing fast on unknown paths."""
    obj: Any = spec
    parts = path.split(".")
    for p in parts[:-1]:
        if not hasattr(obj, p):
            msg = f"sweep override {path!r}: {type(obj).__name__} has no field {p!r}"
            raise AttributeError(msg)
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        msg = f"sweep override {path!r}: {type(obj).__name__} has no field {leaf!r}"
        raise AttributeError(msg)
    setattr(obj, leaf, value)


def _sweep_worker(spec_json: str, device) -> Dict[str, Any]:
    """Run one grid point in a worker process. The spec travels as JSON and
    the engine import happens inside the worker, so nothing unpicklable
    crosses the process boundary."""
    from repro_torch.api.engine import run_scenario

    spec = ScenarioSpec.from_dict(json.loads(spec_json))
    t0 = time.time()
    result = run_scenario(spec, device=device)
    return {"wall_time": time.time() - t0, "result": result.to_json()}


def _grid_points(base_spec: ScenarioSpec, grid: Dict[str, Sequence[Any]]):
    """The cartesian product as (spec, overrides) pairs, in sorted-axis
    grid order."""
    axes = sorted(grid)
    for path, values in grid.items():
        if not isinstance(values, (list, tuple)):
            msg = f"grid[{path!r}] must be a list of values, got {type(values).__name__}"
            raise TypeError(msg)
    points = []
    for combo in product(*(grid[a] for a in axes)):
        spec = copy.deepcopy(base_spec)
        overrides = dict(zip(axes, combo))
        for path, value in overrides.items():
            apply_override(spec, path, value)
        tag = "-".join(f"{p.rsplit('.', 1)[-1]}={v}" for p, v in overrides.items())
        spec.name = f"{base_spec.name}/{tag}" if tag else base_spec.name
        points.append((spec, overrides))
    return axes, points


def sweep_scenarios(
    base_spec: ScenarioSpec,
    grid: Dict[str, Sequence[Any]],
    verbose: bool = False,
    max_workers: Optional[int] = None,
    device=None,
) -> Dict[str, Any]:
    """Run the cartesian product of ``grid`` overrides on ``base_spec``, each
    point on ``device`` (``None`` means CUDA, as ``run_scenario``).

    Returns a JSON-native merged payload::

        {"base": <base spec dict>,
         "grid": {path: [values...]},
         "runs": [{"name": ..., "overrides": {path: value},
                   "wall_time": ..., "result": RunResult.to_json()}]}

    Every point runs on a deep copy of the base spec, which is never
    mutated. ``max_workers > 1`` fans the points out over spawned worker
    processes.
    """
    axes, points = _grid_points(base_spec, grid)
    runs: List[Dict[str, Any]] = []
    if max_workers is not None and max_workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        dev = None if device is None else str(device)
        with ProcessPoolExecutor(max_workers=max_workers,
                                 mp_context=mp.get_context("spawn")) as ex:
            futs = [ex.submit(_sweep_worker, json.dumps(spec.to_dict()), dev)
                    for spec, _ in points]
            for (spec, overrides), fut in zip(points, futs):
                if verbose:
                    print(f"sweep: {spec.name}")
                runs.append({"name": spec.name, "overrides": overrides, **fut.result()})
    else:
        from repro_torch.api.engine import run_scenario

        for spec, overrides in points:
            if verbose:
                print(f"sweep: {spec.name}")
            t0 = time.time()
            result = run_scenario(spec, verbose=verbose, device=device)
            runs.append({"name": spec.name, "overrides": overrides,
                         "wall_time": time.time() - t0, "result": result.to_json()})
    return {
        "base": base_spec.to_dict(),
        "grid": {a: list(grid[a]) for a in axes},
        "runs": runs,
    }
