"""The async slice: the numpy-only modules it runs, bit for bit against the
JAX package, and whole async runs through both ``run_scenario``s.

Whole runs hold the port (``device="cpu"``) to identical event traces
(``time``, ``assignments``, ``versions``, ``arrivals``, ``buffer_sizes``,
``staleness_mean``), accuracies within 1e-3 and final params within 1e-4.
The server optimizers run at a server lr of 0.1 there: at the default of
1.0 an Adam step is sign-like, and rounding in the last place grows flush
by flush (the JAX package's own fused and unfused paths differ by 7e-4
after a dozen flushes at lr 1.0). The ``cuda`` cases run on a card:

    python -m pytest -q -m cuda tests/test_torch_fused.py tests/test_torch_async.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import arrivals as j_arrivals
from repro.api import buffer as j_buffer
from repro.api import costmodel as j_costmodel
from repro.core.mmfl import MMFLCoordinator as JCoordinator
from repro.fed import async_engine as j_async
from repro.fed.data import standard_tasks as j_standard_tasks
import repro_torch.api as tapi
from repro_torch.api import arrivals as t_arrivals
from repro_torch.api import buffer as t_buffer
from repro_torch.api import costmodel as t_costmodel
from repro_torch.api.backend import CohortTask, get_backend
from repro_torch.core.mmfl import MMFLCoordinator as TCoordinator
from repro_torch.fed import async_engine as t_async
from repro_torch.fed.data import standard_tasks
from repro_torch.fed.server import aggregate
from repro_torch.fed.trainer import fed_client_batch, fed_local_fn, task_round_key
from repro_torch.interop import params_to_numpy
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TASKS = ["synth-mnist", "synth-cifar", "synth-fmnist"]
TRACE = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
         "cost_dropouts")


# ------------------------------------------------- numpy modules, bit-exact


@pytest.mark.parametrize("strategy", ["fedfair", "random", "round_robin"])
def test_assign_next_sequence_is_bit_exact(strategy):
    rng = np.random.default_rng(0)
    elig = rng.random((12, 3)) < 0.7
    elig[3] = False
    names = ["a", "b", "c"]
    j = JCoordinator(names, 12, strategy=strategy, seed=5, eligibility=elig.copy())
    t = TCoordinator(names, 12, strategy=tapi.ALLOCATORS.get(strategy), seed=5,
                     eligibility=elig.copy())
    got, want = [], []
    for step in range(80):
        if step % 7 == 0:
            task, loss = names[step % 3], float(rng.uniform(0.05, 0.9))
            j.report(task, loss)
            t.report(task, loss)
        client = int(rng.integers(12))
        want.append(j.assign_next(client))
        got.append(t.assign_next(client))
    assert got == want
    assert [list(t.next_round()[n]) for n in names] == [list(j.next_round()[n]) for n in names]
    assert t.state_dict() == j.state_dict()
    t2 = TCoordinator(names, 12, strategy=tapi.ALLOCATORS.get(strategy), seed=0,
                      eligibility=elig.copy())
    t2.load_state(j.state_dict())
    assert [t2.assign_next(c) for c in range(12)] == [j.assign_next(c) for c in range(12)]
    np.testing.assert_array_equal(t.client_weights(np.arange(5)), j.client_weights(np.arange(5)))


@pytest.mark.parametrize("name,options", [
    ("always_on", {}), ("bursty", {}), ("bursty", {"period": 3.0, "duty": 0.25}),
    ("poisson", {}), ("poisson", {"mean_idle": 0.0}), ("poisson", {"mean_idle": 5.0}),
])
def test_arrival_processes_are_bit_exact(name, options):
    jp = j_arrivals.get_arrival_process(name, options)
    tp = t_arrivals.get_arrival_process(name, options)
    jp.reset(9, np.random.default_rng(2))
    tp.reset(9, np.random.default_rng(2))
    times = np.random.default_rng(1).uniform(0, 20, 40)
    assert [tp.next_start(c % 9, t) for c, t in enumerate(times)] == \
        [jp.next_start(c % 9, t) for c, t in enumerate(times)]
    assert tp.rng.bit_generator.state == jp.rng.bit_generator.state


def test_arrival_process_options_are_checked():
    for name, opts in [("bursty", {"duty": 0.0}), ("bursty", {"period": -1.0}),
                       ("poisson", {"mean_idle": -1.0})]:
        with pytest.raises(ValueError):
            t_arrivals.get_arrival_process(name, opts)
    with pytest.raises(KeyError, match="registered"):
        t_arrivals.get_arrival_process("diurnal")


@pytest.mark.parametrize("name,options", [
    ("static", {}), ("staleness_target", {}),
    ("staleness_target", {"target": 1.5, "step": 2, "max_size": 6, "deadband": 0.0}),
    ("arrival_rate", {}), ("arrival_rate", {"warmup": 0, "max_size": 5}),
])
def test_buffer_controllers_are_bit_exact(name, options):
    jc = j_buffer.get_buffer_controller(name, options)
    tc = t_buffer.get_buffer_controller(name, options)
    jc.reset(3, 4)
    tc.reset(3, 4)
    rng = np.random.default_rng(4)
    arrivals = np.zeros(3, np.int64)
    for f in range(1, 30):
        arrivals += rng.integers(0, 4, 3)
        kw = dict(flush=f, task=int(rng.integers(3)), time=float(f),
                  staleness_mean=float(rng.uniform(0, 4)), kept=4, arrivals=arrivals.copy(),
                  sizes=tc.sizes().copy())
        jc.observe(j_buffer.FlushObservation(**kw))
        tc.observe(t_buffer.FlushObservation(**kw))
        np.testing.assert_array_equal(tc.sizes(), jc.sizes())
        assert tc.sizes().dtype == jc.sizes().dtype


@pytest.mark.parametrize("options", [
    {}, {"comm_scale": 0.0},
    {"tiers": {"phone": {"speed": 0.25, "fraction": 0.4}, "laptop": {"speed": 1.0, "fraction": 0.4},
               "server": {"speed": 4.0, "fraction": 0.2}}, "comm_scale": 0.25},
])
def test_device_tiers_is_bit_exact(options):
    jm = j_costmodel.get_cost_model("device_tiers", options)
    tm = t_costmodel.get_cost_model("device_tiers", options)
    sizes = [1738.0, 6922.0, 3786.0]
    jm.reset(10, 3, np.random.default_rng(3), task_sizes=sizes)
    tm.reset(10, 3, np.random.default_rng(3), task_sizes=sizes)
    for c in range(10):
        for s in range(3):
            a = jm.sample_latency(c, s, 1.0 / (c + 1))
            b = tm.sample_latency(c, s, 1.0 / (c + 1))
            assert (b.compute, b.comm, b.dropout, b.total) == (a.compute, a.comm, a.dropout,
                                                               a.total)
    assert tm.rng.bit_generator.state == jm.rng.bit_generator.state


@pytest.mark.parametrize("options", [
    {"comm_scale": -1.0}, {"tiers": {}}, {"tiers": {"x": {"speed": 1.0}}},
    {"bandwidths": {"x": {"rate": 0.0, "fraction": 1.0}}}, {"speed": 2.0},
])
def test_device_tiers_options_are_checked(options):
    with pytest.raises(ValueError):
        j_costmodel.get_cost_model("device_tiers", options)
    with pytest.raises(ValueError):
        t_costmodel.get_cost_model("device_tiers", options)


@pytest.mark.parametrize("profile", ["uniform", "bimodal", "lognormal"])
def test_client_speeds_are_bit_exact(profile):
    want = j_async.client_speeds(profile, 20, np.random.default_rng(1), spread=3.0)
    got = t_async.client_speeds(profile, 20, np.random.default_rng(1), spread=3.0)
    np.testing.assert_array_equal(got, want)


def test_resolve_buffer_size_matches_reference_on_the_cpu():
    for size, backend in [(None, "serial"), (None, "vmap"), (7, "vmap"), (1, "serial")]:
        assert t_async.resolve_buffer_size(size, backend, "cpu") == \
            j_async.resolve_buffer_size(size, backend)
    for bad in (0, -2):
        with pytest.raises(ValueError, match=">= 1"):
            t_async.resolve_buffer_size(bad, "serial", "cpu")


# ------------------------------------------------------------- whole runs


def _spec(api, aggregator=None, options=None, strategy="fedfair", **runtime):
    rt = dict(mode="async", backend="vmap", tau=2, total_arrivals=40, buffer_size=3,
              aggregator=aggregator, aggregator_options=dict(options or {}))
    rt.update(runtime)
    return api.ScenarioSpec(
        name="async-parity", seed=0,
        tasks=[api.TaskSpec(n, options={"n_range": [40, 60], "n_test": 300}) for n in TASKS],
        clients=api.ClientPopulationSpec(n_clients=10, speed_profile="bimodal",
                                         speed_spread=4.0),
        allocation=api.AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=api.RuntimeSpec(**rt))


def _assert_runs_match(rt, rj):
    for key in TRACE:
        np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
    assert rt.assignments == rj.assignments
    assert rt.task_names == rj.task_names and rt.mode == rj.mode == "async"
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-3, rtol=0)
    assert rt.virtual_time == rj.virtual_time
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)
    js, jj = rt.to_json(), rj.to_json()
    assert set(js) == set(jj) and js["spec"] == jj["spec"]
    assert js["final_buffer_sizes"] == jj["final_buffer_sizes"]


@pytest.mark.parametrize("aggregator,options", [
    (None, None), ("fedavg", None), ("fedavgm", {"lr": 0.1}), ("fedadam", {"lr": 0.1}),
    ("fedyogi", {"lr": 0.1}),
], ids=["default", "fedavg", "fedavgm", "fedadam", "fedyogi"])
def test_async_run_matches_reference(aggregator, options):
    rj = japi.run_scenario(_spec(japi, aggregator, options))
    rt = tapi.run_scenario(_spec(tapi, aggregator, options), device="cpu")
    assert len(rt.time) >= 10
    _assert_runs_match(rt, rj)
    assert all(leaf.device.type == "cpu" for p in rt.params for leaf in tree_leaves(p))


@pytest.mark.parametrize("name", ["device_skew.json", "adaptive_buffers.json"])
def test_example_spec_matches_reference(name):
    path = ROOT / "examples" / "specs" / name
    rj = japi.run_scenario(japi.ScenarioSpec.load(str(path)))
    rt = tapi.run_scenario(tapi.ScenarioSpec.load(str(path)), device="cpu")
    _assert_runs_match(rt, rj)
    if name == "adaptive_buffers.json":
        assert len(np.unique(rt.buffer_sizes)) > 1     # the controller moved


def test_round_robin_with_arrival_process_matches_reference():
    kw = dict(strategy="round_robin", total_arrivals=30)
    sj, st = _spec(japi, **kw), _spec(tapi, **kw)
    for s in (sj, st):
        s.clients.arrival_process = "poisson"
        s.clients.arrival_options = {"mean_idle": 1.0}
        s.runtime.max_staleness = 1
    _assert_runs_match(tapi.run_scenario(st, device="cpu"), japi.run_scenario(sj))


@pytest.mark.parametrize("aggregator", ["fedavgm", "fedadam", "fedyogi"])
def test_server_optimizers_in_sync_mode_match_reference(aggregator):
    """The sync trainer folds through the generic per-leaf ``aggregate``
    (no kernel), as in the reference."""
    def spec(api):
        return api.ScenarioSpec(
            name="sync-opt", seed=0,
            tasks=[api.TaskSpec(n, options={"n_range": [40, 60], "n_test": 300})
                   for n in TASKS],
            clients=api.ClientPopulationSpec(n_clients=10, participation=0.5),
            runtime=api.RuntimeSpec(backend="vmap", rounds=3, tau=2, aggregator=aggregator,
                                    aggregator_options={"lr": 0.1}))
    rj = japi.run_scenario(spec(japi))
    rt = tapi.run_scenario(spec(tapi), device="cpu")
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)


def test_serial_backend_async_run_matches_vmap():
    a = tapi.run_scenario(_spec(tapi, "fedadam", backend="serial"), device="cpu")
    b = tapi.run_scenario(_spec(tapi, "fedadam", backend="vmap"), device="cpu")
    for key in TRACE:
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_allclose(a.acc, b.acc, atol=1e-6, rtol=0)


def test_equal_speeds_full_buffer_equals_sync_round():
    """Equal client speeds and buffer_size == cohort size: the async
    engine's first flush reproduces the sync round's params to 1e-6 (one
    task, every client)."""
    K = 10
    tasks = standard_tasks(["synth-mnist"], n_clients=K, seed=0, n_range=(40, 60))
    cfg = t_async.AsyncConfig(total_arrivals=K, buffer_size=K, tau=3, seed=0,
                              speed_profile="uniform")
    eng = t_async.AsyncMMFLEngine.from_fed_tasks(tasks, cfg, device="cpu")
    p0 = eng.tasks[0].init(0)
    h = eng.run()
    assert h.versions.tolist() == [1] and h.staleness_mean.tolist() == [0.0]
    cohort = get_backend("serial", "cpu").run_cohort(
        CohortTask("m", p0, fed_local_fn(3, 0.1, 32)),
        fed_client_batch(tasks[0], task_round_key(0, 0, 0), np.arange(K), "cpu")).updates
    sync_p = aggregate(cohort, torch.from_numpy(tasks[0].p_k).float())
    for a, b in zip(tree_leaves(sync_p), tree_leaves(eng._params[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_history_fields_match_reference_engine():
    """The engines' own histories (not only the RunResult) agree."""
    cfg = dict(total_arrivals=24, buffer_size=3, tau=2, seed=1, speed_profile="lognormal",
               speed_spread=3.0, backend="vmap", aggregator="fedadam",
               aggregator_options={"lr": 0.1})
    jt = j_standard_tasks(TASKS[:2], n_clients=8, seed=1, n_range=(40, 60))
    tt = standard_tasks(TASKS[:2], n_clients=8, seed=1, n_range=(40, 60))
    hj = j_async.AsyncMMFLEngine.from_fed_tasks(jt, j_async.AsyncConfig(**cfg)).run()
    ht = t_async.AsyncMMFLEngine.from_fed_tasks(tt, t_async.AsyncConfig(**cfg),
                                                device="cpu").run()
    for key in ("time", "task", "arrivals", "updates_per_client", "versions", "buffer_sizes",
                "staleness_mean", "wall_clock_sim"):
        np.testing.assert_array_equal(getattr(ht, key), getattr(hj, key), err_msg=key)
    assert ht.assignments == hj.assignments
    np.testing.assert_allclose(ht.metric, hj.metric, atol=1e-3, rtol=0)
    np.testing.assert_allclose(ht.min_acc, hj.min_acc, atol=1e-3, rtol=0)
    assert hj.acc_eval is None      # fed tasks: accuracy is 1 - f_s in both


# --------------------------------------------------- refusals and checks


def _with(spec, **changes):
    for path, value in changes.items():
        obj = spec
        *head, last = path.split("__")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return spec


@pytest.mark.parametrize("changes,err,match", [
    (dict(clients__population="nope"), KeyError, "population"),
    (dict(clients__population="vectorized", clients__population_options={"warp_factor": 9}),
     ValueError, "bad options for population"),
    (dict(runtime__cost_model="lognormal_straggler",
          runtime__cost_model_options={"sigma": -1.0}), ValueError, "sigma must be >= 0"),
    (dict(runtime__aggregator="trimmed_mean",
          runtime__aggregator_options={"trim": 0.5}), ValueError, "trim must be in"),
    (dict(runtime__aggregator="qfedavg",
          runtime__aggregator_options={"q": -1.0}), ValueError, "q must be >= 0"),
    (dict(auction=tapi.AuctionSpec(budget=0.0)), ValueError, "budget must be positive"),
    (dict(clients__arrival_process="diurnal"), KeyError, "arrival_process"),
    (dict(runtime__buffer_controller="pid"), KeyError, "buffer_controller"),
    (dict(runtime__aggregator="fedsgd"), KeyError, "aggregator"),
    (dict(runtime__buffer_size=0), ValueError, ">= 1"),
    (dict(runtime__buffer_controller_options={"target": 2.0}), ValueError, "without a"),
    (dict(runtime__buffer_controller="static",
          runtime__buffer_controller_options={"target": 2.0}), ValueError, "rejected"),
    (dict(runtime__aggregator="fedadam", runtime__aggregator_options={"lr": -1.0}),
     ValueError, "lr"),
])
def test_async_spec_refusals(changes, err, match):
    spec = _with(_spec(tapi, total_arrivals=4), **changes)
    with pytest.raises(err, match=match):
        tapi.run_scenario(spec, device="cpu")


def test_engine_refuses_unported_config():
    """Populations and checkpoints are ported: the engine builds with them,
    and refuses only their misconfigurations, as the reference does."""
    tasks = standard_tasks(["synth-mnist"], n_clients=4, seed=0, n_range=(40, 60))
    eng = t_async.AsyncMMFLEngine.from_fed_tasks(
        tasks, t_async.AsyncConfig(population="vectorized", checkpoint_dir=None, resume=True),
        device="cpu")
    assert eng.population is not None and eng.arrival is eng.population.arrival
    for kw, err, match in [(dict(population_options={"lazy_data": True}), ValueError,
                            "population_options"),
                           (dict(population="nope"), KeyError, "nope"),
                           (dict(population="vectorized", population_options={"bad": 1}),
                            ValueError, "bad options for population")]:
        with pytest.raises(err, match=match):
            t_async.AsyncMMFLEngine.from_fed_tasks(tasks, t_async.AsyncConfig(**kw),
                                                   device="cpu")


def test_buffer_controller_in_sync_mode_raises():
    spec = _with(_spec(tapi), runtime__mode="sync", runtime__buffer_controller="static")
    with pytest.raises(ValueError, match="only applies to mode='async'"):
        tapi.run_scenario(spec, device="cpu")


def test_async_run_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.run_scenario(_spec(tapi, total_arrivals=4))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator,kernel", [("fedadam", "fused_aggregate"),
                                               (None, "fedavg")])
def test_async_on_cuda_launches_kernel_once_per_flush(cuda_device, aggregator, kernel):
    from repro_torch.kernels import LAUNCHES, reset_launches

    spec = _spec(tapi, aggregator, strategy="round_robin")
    reset_launches()
    gpu = tapi.run_scenario(spec)
    assert dict(LAUNCHES) == {kernel: len(gpu.time)}
    assert all(leaf.device.type == "cuda" for p in gpu.params for leaf in tree_leaves(p))
    cpu = tapi.run_scenario(spec, device="cpu")
    for key in TRACE:
        np.testing.assert_array_equal(getattr(gpu, key), getattr(cpu, key))
    assert gpu.assignments == cpu.assignments
    np.testing.assert_allclose(gpu.acc, cpu.acc, atol=0.01, rtol=0)


@pytest.mark.cuda
def test_async_server_state_stays_on_cuda(cuda_device):
    tasks = standard_tasks(TASKS[:2], n_clients=8, seed=0, n_range=(40, 60))
    cfg = t_async.AsyncConfig(total_arrivals=16, buffer_size=3, tau=2, backend="vmap",
                              aggregator="fedyogi")
    eng = t_async.AsyncMMFLEngine.from_fed_tasks(tasks, cfg)
    h = eng.run()
    assert len(h.time) > 0 and np.isfinite(h.metric).all()
    for state in eng._server_state:
        assert {leaf.device.type for leaf in tree_leaves(state)} == {"cuda"}
