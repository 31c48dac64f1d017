"""The port's ``sharded`` cohort backend (``api/backend.py::ShardedBackend``)
through ``run_scenario(device="cpu")``, mirroring ``tests/test_backends.py``.

On a one-device mesh (the CPU's ``(cpu,)``) it takes ``vmap``'s path; an
explicit mesh of repeated CPU devices (the port's stand-in for XLA's
forced host device count) splits each cohort into parts, one
``local_fn`` call a part, and gathers them in cohort order. Each run is
held against ``serial`` and ``vmap`` within 1e-6 with identical traces,
and against the JAX package's ``sharded`` run within the tolerances of
``tests/test_torch_scenario.py``."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.api.backend import ClientBatch, CohortTask, ShardedBackend, VmapBackend
from repro_torch.interop import params_to_numpy
from repro_torch.tree import tree_leaves

EVENTS = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean")
SYNC = dict(rounds=3, tau=2)
ASYNC = dict(mode="async", total_arrivals=20, buffer_size=4, tau=2)


def two_task_spec(api, backend="serial", mode="sync", **runtime_kw):
    return api.ScenarioSpec(
        name="bk",
        seed=0,
        tasks=[api.TaskSpec("synth-mnist", options={"n_range": [40, 60]}),
               api.TaskSpec("synth-fmnist", options={"n_range": [40, 60]})],
        clients=api.ClientPopulationSpec(n_clients=10, participation=1.0),
        runtime=api.RuntimeSpec(mode=mode, backend=backend, **runtime_kw))


@pytest.fixture
def forced_mesh(monkeypatch):
    """Register ``sharded`` backends over ``n`` repeated CPU devices for
    this test; returns the registry key of each."""
    def register(n: int) -> str:
        name = f"sharded-cpu{n}"

        class Forced(ShardedBackend):
            def __init__(self, device=None):
                super().__init__(device, mesh=("cpu",) * n)

        monkeypatch.setitem(tapi.BACKENDS._items, name, Forced)
        return name

    return register


def _assert_runs_equal(got, want, atol=1e-6):
    np.testing.assert_array_equal(got.alloc, want.alloc)
    np.testing.assert_allclose(got.loss, want.loss, atol=atol, rtol=0)
    np.testing.assert_allclose(got.acc, want.acc, atol=atol, rtol=0)
    if got.mode == "async":
        for k in EVENTS:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert got.assignments == want.assignments
    else:
        np.testing.assert_array_equal(got.alloc_counts, want.alloc_counts)
    for a, b in zip(tree_leaves(params_to_numpy(got.params)),
                    tree_leaves(params_to_numpy(want.params))):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def test_sharded_is_registered_and_exported():
    assert {"serial", "vmap", "sharded"} <= set(tapi.BACKENDS.names())
    assert tapi.ShardedBackend is ShardedBackend
    assert isinstance(tapi.get_backend("sharded", device="cpu"), ShardedBackend)


@pytest.mark.parametrize("kw", [SYNC, ASYNC], ids=["sync", "async"])
def test_sharded_run_matches_serial(kw):
    """``tests/test_backends.py``'s parity: sharded reproduces serial within
    1e-6 (curves and final params) with identical traces."""
    base = tapi.run_scenario(two_task_spec(tapi, "serial", **kw), device="cpu")
    got = tapi.run_scenario(two_task_spec(tapi, "sharded", **kw), device="cpu")
    _assert_runs_equal(got, base)


@pytest.mark.parametrize("kw", [SYNC, ASYNC], ids=["sync", "async"])
def test_sharded_run_matches_reference(kw):
    """The same spec through the JAX package's ``sharded`` backend (its
    ``vmap`` path on one CPU device): identical traces, curves within
    1e-3 and params within 1e-4."""
    rj = japi.run_scenario(two_task_spec(japi, "sharded", **kw))
    rt = tapi.run_scenario(two_task_spec(tapi, "sharded", **kw), device="cpu")
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    if rt.mode == "async":
        for k in EVENTS:
            np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k))
    else:
        np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-3, rtol=0)
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kw", [SYNC, ASYNC], ids=["sync", "async"])
def test_forced_mesh_run_matches_vmap(kw, n, forced_mesh):
    """Over a mesh of 2 or 3 CPU entries each cohort runs in parts (the
    10-client sync cohorts split 5/5 and 4/3/3, the 4-client flushes 2/2
    and 2/1/1) and equals ``vmap`` within 1e-6 with identical traces."""
    want = tapi.run_scenario(two_task_spec(tapi, "vmap", **kw), device="cpu")
    got = tapi.run_scenario(two_task_spec(tapi, forced_mesh(n), **kw), device="cpu")
    _assert_runs_equal(got, want)


def _cohort(n_clients: int):
    from repro_torch.fed import standard_tasks
    from repro_torch.fed.trainer import (fed_client_batch, fed_local_fn, init_task_models,
                                         task_round_key)
    from repro_torch import prng

    task = standard_tasks(["synth-mnist"], n_clients=10, seed=0, n_range=(40, 60))[0]
    params = init_task_models([task], prng.PRNGKey(0), 64, 2, device="cpu")[0]
    batch = fed_client_batch(task, task_round_key(0, 0, 0), np.arange(n_clients), device="cpu")
    return CohortTask("t", params, fed_local_fn(3, 0.1, 32)), batch


@pytest.mark.parametrize("n_clients,parts", [(10, [4, 3, 3]), (2, [1, 1])],
                         ids=["uneven", "one-empty-part"])
def test_three_entry_mesh_splits_in_cohort_order(n_clients, parts):
    """A 10-client cohort on a 3-entry mesh runs as 4/3/3, a 2-client one
    as 1/1 with the third part empty and skipped; each part is one
    ``local_fn`` call, and the gathered updates equal ``vmap``'s within
    1e-6 in cohort order."""
    job, batch = _cohort(n_clients)
    seen = []

    def counting(params, keys, *data):
        seen.append(data[0].shape[0])
        return job.local_fn(params, keys, *data)

    want = VmapBackend(device="cpu").run_cohort(job, batch)
    got = ShardedBackend(device="cpu", mesh=("cpu",) * 3).run_cohort(
        CohortTask("t", job.params, counting), batch)
    assert seen == parts
    assert got.losses.shape == (n_clients,)
    for a, b in zip(tree_leaves(want.updates), tree_leaves(got.updates)):
        assert b.shape == a.shape
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)


def test_one_device_mesh_and_single_client_take_vmaps_path():
    """A one-entry mesh, or a cohort of one, makes one ``local_fn`` call
    over the whole cohort, as ``vmap`` does."""
    job, batch = _cohort(6)
    calls = []

    def counting(params, keys, *data):
        calls.append(data[0].shape[0])
        return job.local_fn(params, keys, *data)

    task = CohortTask("t", job.params, counting)
    ShardedBackend(device="cpu").run_cohort(task, batch)
    one = ClientBatch(batch.client_ids[:1], batch.keys[:1], tuple(d[:1] for d in batch.data))
    ShardedBackend(device="cpu", mesh=("cpu",) * 3).run_cohort(task, one)
    assert calls == [6, 1]


def test_backend_aggregate_matches_server_aggregate():
    """Every backend's fold equals ``fed/server.py::aggregate``."""
    from repro_torch.fed.server import aggregate

    cohort = {"w": torch.arange(24.0).reshape(4, 3, 2)}
    weights = torch.tensor([0.1, 0.4, 0.2, 0.3])
    ref = aggregate(cohort, weights)
    for backend in ("serial", "vmap", "sharded"):
        got = tapi.get_backend(backend, device="cpu").aggregate(cohort, weights)
        torch.testing.assert_close(got["w"], ref["w"], atol=1e-6, rtol=0)
