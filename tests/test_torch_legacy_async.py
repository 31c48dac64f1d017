"""The legacy async adapter path against the JAX package: an ``AsyncTask``
that overrides only ``update()`` (``local_fn`` left unset) drives the
port's engine and ``run_scenario`` without backend dispatch, as in the
reference (``tests/test_backends.py``), and ``fed.trainer.cohort_update``
is the reference's cohort entry point. Inputs come from numpy seeds;
params cross via ``repro_torch.interop``."""
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import engine as j_engine
from repro.fed import async_engine as j_async
from repro.fed import trainer as j_trainer
from repro.fed.data import standard_tasks as j_standard_tasks
import repro_torch.api as tapi
from repro_torch.api import engine as t_engine
from repro_torch.fed import async_engine as t_async
from repro_torch.fed import trainer as t_trainer
from repro_torch.fed.data import standard_tasks
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.tree import tree_leaves

CPU = "cpu"
TASKS = ["synth-mnist", "synth-cifar"]


def _legacy_class(base, trainer, cfg, task, **kw):
    """An adapter of the reference's pre-backend kind: ``local_fn`` stays
    None and ``update()`` runs the cohort through ``cohort_update``."""

    class Legacy(base):
        def __init__(self):
            self.name, self.n_clients = "legacy", task.n_clients
            self.p_k, self.work = task.p_k, 1.0
            self._ref = (j_async.FedAsyncTask(task, 0, cfg) if base is j_async.AsyncTask
                         else t_async.FedAsyncTask(task, 0, cfg, device=CPU))

        def init(self, seed):
            return self._ref.init(seed)

        def update(self, params, seed, version, ids):
            return trainer.cohort_update(params, trainer.task_round_key(seed, 0, version),
                                         task, ids, cfg.tau, cfg.lr, cfg.batch_size, **kw)

        def evaluate(self, params):
            return self._ref.evaluate(params)

    return Legacy


def _cfg(api_async):
    return api_async.AsyncConfig(total_arrivals=6, buffer_size=3, tau=2, seed=0)


def _tasks():
    kw = dict(n_clients=6, seed=0, n_range=(40, 60))
    return j_standard_tasks(["synth-mnist"], **kw)[0], standard_tasks(["synth-mnist"], **kw)[0]


def test_legacy_update_only_adapter_matches_modern_and_reference():
    jt, tt = _tasks()
    jcfg, tcfg = _cfg(j_async), _cfg(t_async)
    modern = t_async.AsyncMMFLEngine([t_async.FedAsyncTask(tt, 0, tcfg, device=CPU)], tcfg,
                                     device=CPU).run()
    legacy = t_async.AsyncMMFLEngine(
        [_legacy_class(t_async.AsyncTask, t_trainer, tcfg, tt, device=CPU)()], tcfg,
        device=CPU).run()
    ref = j_async.AsyncMMFLEngine([_legacy_class(j_async.AsyncTask, j_trainer, jcfg, jt)()],
                                  jcfg).run()
    assert len(legacy.time) == len(modern.time) == len(ref.time) > 0
    np.testing.assert_allclose(legacy.metric, modern.metric, atol=1e-6, rtol=0)
    for key in ("time", "task", "versions", "arrivals", "staleness_mean"):
        np.testing.assert_array_equal(getattr(legacy, key), getattr(modern, key), err_msg=key)
        np.testing.assert_array_equal(getattr(legacy, key), getattr(ref, key), err_msg=key)
    assert legacy.assignments == ref.assignments
    np.testing.assert_allclose(legacy.metric, ref.metric, atol=1e-3, rtol=0)


def test_bare_adapter_raises_naming_local_fn():
    _, tt = _tasks()
    bare = _legacy_class(t_async.AsyncTask, t_trainer, _cfg(t_async), tt, device=CPU)()
    bare.update = t_async.AsyncTask.update.__get__(bare)
    with pytest.raises(NotImplementedError, match="local_fn"):
        bare.update(bare.init(0), 0, 0, np.arange(2))


def test_default_update_runs_local_fn_on_the_serial_backend():
    """``AsyncTask.update`` (local_fn through the serial backend) and
    ``FedAsyncTask.update`` (one batched cohort) give the same cohort."""
    _, tt = _tasks()
    adapter = t_async.FedAsyncTask(tt, 0, _cfg(t_async), device=CPU)
    params, ids = adapter.init(0), np.array([4, 1, 3])
    serial = t_async.AsyncTask.update(adapter, params, 0, 2, ids)
    batched = adapter.update(params, 0, 2, ids)
    for a, b in zip(tree_leaves(serial), tree_leaves(batched)):
        assert a.shape[0] == len(ids)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _legacy_fed(base, trainer, **kw):
    """``FedAsyncTask`` made legacy: ``local_fn`` unset, the cohort through
    an ``update()`` override, everything else as the adapter has it."""

    class LegacyFed(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.local_fn = None

        def update(self, params, seed, version, ids):
            return trainer.cohort_update(
                params, trainer.task_round_key(seed, self.task_idx, version), self.task, ids,
                self.cfg.tau, self.cfg.lr, self.cfg.batch_size, **kw)

    return LegacyFed


def _spec(api, backend):
    return api.ScenarioSpec(
        name="legacy-async", seed=0,
        tasks=[api.TaskSpec(n, options={"n_range": [40, 60], "n_test": 300}) for n in TASKS],
        clients=api.ClientPopulationSpec(n_clients=8, speed_profile="bimodal",
                                         speed_spread=4.0),
        allocation=api.AllocationSpec(strategy="fedfair", alpha=3.0),
        runtime=api.RuntimeSpec(mode="async", backend=backend, tau=2, total_arrivals=24,
                                buffer_size=3))


@pytest.mark.parametrize("backend", ["serial", "vmap"])
def test_legacy_adapters_through_run_scenario(backend, monkeypatch):
    modern = tapi.run_scenario(_spec(tapi, backend), device=CPU)
    monkeypatch.setattr(t_engine, "FedAsyncTask",
                        _legacy_fed(t_async.FedAsyncTask, t_trainer, device=CPU))
    monkeypatch.setattr(j_engine, "FedAsyncTask", _legacy_fed(j_async.FedAsyncTask, j_trainer))
    legacy = tapi.run_scenario(_spec(tapi, backend), device=CPU)
    ref = japi.run_scenario(_spec(japi, backend))
    assert len(legacy.time) == len(modern.time) == len(ref.time) >= 4
    np.testing.assert_allclose(legacy.loss, modern.loss, atol=1e-6, rtol=0)
    for key in ("time", "versions", "arrivals", "staleness_mean", "buffer_sizes"):
        np.testing.assert_array_equal(getattr(legacy, key), getattr(modern, key), err_msg=key)
        np.testing.assert_array_equal(getattr(legacy, key), getattr(ref, key), err_msg=key)
    assert legacy.assignments == ref.assignments
    np.testing.assert_allclose(legacy.loss, ref.loss, atol=1e-3, rtol=0)
    for pj, pt in zip(ref.params, params_to_numpy(legacy.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("ids", [[3], [0, 5, 2], [1, 2, 3, 4], [0, 2, 3, 7, 9],
                                 [9, 8, 7, 6, 5, 4, 3, 2, 1]],
                         ids=["1", "3-padded", "4-unpadded", "5-padded", "9-padded"])
def test_cohort_update_matches_reference(ids):
    kw = dict(n_clients=10, seed=5, n_range=(40, 60))
    tj = j_standard_tasks(["synth-cifar"], **kw)[0]
    tp = standard_tasks(["synth-cifar"], **kw)[0]
    pj = j_trainer.init_task_model(tj, j_trainer.task_round_key(2, 0, 0), 16, 2)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), device=CPU)
    ids = np.asarray(ids)
    want = j_trainer.cohort_update(pj, j_trainer.task_round_key(1, 0, 3), tj, ids, 3, 0.1, 32)
    got = t_trainer.cohort_update(pt, t_trainer.task_round_key(1, 0, 3), tp, ids, 3, 0.1, 32,
                                  device=CPU)
    for lj, lt in zip(want, params_to_numpy(got)):
        for k in ("w", "b"):
            assert lt[k].shape == np.asarray(lj[k]).shape and lt[k].shape[0] == len(ids)
            np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-5, rtol=0)


def test_cohort_update_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tt = _tasks()
    params = t_async.FedAsyncTask(tt, 0, _cfg(t_async), device=CPU).init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_trainer.cohort_update(params, t_trainer.task_round_key(0, 0, 0), tt, [0, 1], 2,
                                0.1, 32)
