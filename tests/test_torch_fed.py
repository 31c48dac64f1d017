"""The port's numpy layer and one-round tensor path against the JAX
package: FedTask data, allocation, policies, fairness, init, local SGD,
the execution backends and the fedavg aggregator. Inputs come from numpy
seeds; params cross via repro_torch.interop."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import allocation as jalloc
from repro.core import fairness as jfair
from repro.fed import client as jclient
from repro.fed import data as jdata
from repro.fed import trainer as jtrainer
from repro_torch import interop, prng
from repro_torch.api import aggregator as tagg
from repro_torch.api import backend as tbackend
from repro_torch.api import policy as tpolicy
from repro_torch.api import spec as tspec
from repro_torch.core import allocation as talloc
from repro_torch.core import fairness as tfair
from repro_torch.fed import client as tclient
from repro_torch.fed import data as tdata
from repro_torch.fed import trainer as ttrainer

CPU = "cpu"
SPECS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "examples", "specs",
                                      "*.json")))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(jax_params, port_params, atol):
    port = interop.params_to_numpy(port_params)
    for lj, lp in zip(jax_params, port):
        for k in ("w", "b"):
            np.testing.assert_allclose(lp[k], np.asarray(lj[k]), atol=atol, rtol=0)


def _task(name="synth-mnist", n_clients=8, seed=5):
    kw = dict(jdata._RECIPES[name.split("#")[0]])
    return (jdata.make_synthetic_task(seed, name, n_clients, n_range=(40, 60), n_test=200, **kw),
            tdata.make_synthetic_task(seed, name, n_clients, n_range=(40, 60), n_test=200, **kw))


@pytest.mark.parametrize("name", sorted(jdata._RECIPES))
def test_fedtask_arrays_byte_identical(name):
    tj = jdata.standard_tasks([name], n_clients=9, seed=3, n_range=(30, 50))[0]
    tp = tdata.standard_tasks([name], n_clients=9, seed=3, n_range=(30, 50))[0]
    for field in ("train_x", "train_y", "train_w", "test_x", "test_y"):
        a, b = getattr(tj, field), getattr(tp, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), field
    assert tj.p_k.tobytes() == tp.p_k.tobytes()
    assert tj.n_classes == tp.n_classes


@pytest.mark.parametrize("alpha", [1.0, 2.0, 3.0, 10.0, 50.0])
def test_alpha_fair_probs_close(alpha):
    rng = np.random.default_rng(int(alpha))
    for _ in range(5):
        losses = rng.uniform(1e-6, 1.0, size=rng.integers(1, 6))
        want = np.asarray(jalloc.alpha_fair_probs(losses, alpha))
        got = talloc.alpha_fair_probs(losses, alpha)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("strategy", ["fedfair", "random", "round_robin"])
def test_legacy_policy_allocate_identical(strategy):
    rng = np.random.default_rng(1)
    pj = japi.LegacyStrategyPolicy(strategy)
    pt = tpolicy.LegacyStrategyPolicy(strategy)
    names = ["a", "b", "c"]
    cases = [rng.uniform(0.01, 1.0, 3) for _ in range(5)]
    cases += [np.array([np.inf, 0.3, 0.5]), np.full(3, np.inf)]
    for losses in cases:
        cj = japi.RoundContext(round=0, task_names=names, losses=losses, alpha=3.0)
        ct = tpolicy.RoundContext(round=0, task_names=names, losses=losses, alpha=3.0)
        a, b = pj.allocate(cj), pt.allocate(ct)
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_fairness_metrics_match():
    rng = np.random.default_rng(4)
    accs = rng.uniform(0.2, 1.0, size=(12, 3))
    times = np.cumsum(rng.uniform(0.5, 2.0, size=12))
    assert tfair.fairness_report(accs[-1]) == jfair.fairness_report(accs[-1])
    assert tfair.cosine_uniformity(accs[3]) == jfair.cosine_uniformity(accs[3])
    for target in (0.5, 0.9, 0.99):
        assert (tfair.time_to_accuracy_report(times, accs, target, ["a", "b", "c"])
                == jfair.time_to_accuracy_report(times, accs, target, ["a", "b", "c"]))
    np.testing.assert_allclose(tfair.alpha_fair_objective(1 - accs[-1], 3.0),
                               np.asarray(jfair.alpha_fair_objective(1 - accs[-1], 3.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("path", SPECS, ids=os.path.basename)
def test_spec_files_round_trip_identically(path):
    with open(path) as f:
        text = f.read()
    sj = japi.ScenarioSpec.from_json(text)
    st = tspec.ScenarioSpec.from_json(text)
    assert st.to_json() == sj.to_json()
    assert tspec.ScenarioSpec.from_json(st.to_json()).to_json() == st.to_json()


@pytest.mark.parametrize("name,depth", [("synth-mnist", 2), ("synth-cifar", 3),
                                        ("synth-fmnist", 2)])
def test_init_task_model_close(name, depth):
    tj, tp = _task(name)
    pj = jtrainer.init_task_model(tj, jax.random.PRNGKey(4), 64, depth)
    pt = ttrainer.init_task_model(tp, prng.PRNGKey(4), 64, depth, device=CPU)
    assert [tuple(layer["w"].shape) for layer in pt] == [layer["w"].shape for layer in pj]
    _assert_params_close(pj, pt, atol=1e-6)


def _start(tj, seed=2):
    """Identical starting params on both sides (JAX init, carried across)."""
    pj = jtrainer.init_task_model(tj, jax.random.PRNGKey(seed), 64, 2)
    return pj, interop.params_from_numpy(_tree_np(pj), device=CPU)


@pytest.mark.parametrize("client", [0, 5])
def test_local_update_one_client_close(client):
    tj, tp = _task("synth-fmnist")
    pj, pt = _start(tj)
    kj = jax.random.fold_in(jtrainer.task_round_key(0, 1, 2), client)
    kt = prng.fold_in(ttrainer.task_round_key(0, 1, 2), client)
    got = tclient.local_update(pt, kt, torch.from_numpy(tp.train_x[client]),
                               torch.from_numpy(tp.train_y[client]),
                               torch.from_numpy(tp.train_w[client]), tau=5, lr=0.1)
    want = jclient.local_update(pj, kj, tj.train_x[client], tj.train_y[client],
                                tj.train_w[client], 5, 0.1)
    _assert_params_close(want, got, atol=1e-5)


def test_local_update_injected_indices_match_drawn():
    """Indices injected from the reference's own draws give the same
    update as indices drawn by the port from the same key."""
    tj, tp = _task()
    _, pt = _start(tj)
    kj = jax.random.PRNGKey(9)
    idx = np.stack([np.asarray(jax.random.randint(k, (32,), 0, tj.train_x.shape[1]))
                    for k in jax.random.split(kj, 5)])
    args = (torch.from_numpy(tp.train_x[1]), torch.from_numpy(tp.train_y[1]),
            torch.from_numpy(tp.train_w[1]))
    drawn = tclient.local_update(pt, prng.PRNGKey(9), *args, tau=5, lr=0.1)
    injected = tclient.local_update(pt, None, *args, tau=5, lr=0.1,
                                    idx=torch.from_numpy(idx).long())
    for a, b in zip(drawn, injected):
        torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)


def _cohorts(ids, tau=5):
    tj, tp = _task("synth-cifar", n_clients=10)
    pj, pt = _start(tj)
    kj, kt = jtrainer.task_round_key(1, 0, 3), ttrainer.task_round_key(1, 0, 3)
    want = jtrainer.cohort_update(pj, kj, tj, ids, tau, 0.1, 32)
    task = tbackend.CohortTask("t", pt, ttrainer.fed_local_fn(tau, 0.1, 32))
    batch = ttrainer.fed_client_batch(tp, kt, ids, device=CPU)
    return tj, tp, pj, pt, want, task, batch


def test_vmap_cohort_local_update_close():
    ids = np.array([0, 2, 3, 7, 9])
    _, _, _, _, want, task, batch = _cohorts(ids)
    res = tbackend.VmapBackend(device=CPU).run_cohort(task, batch)
    _assert_params_close(want, res.updates, atol=1e-5)
    assert res.losses.shape == (len(ids),)


def test_serial_and_vmap_agree():
    ids = np.array([1, 4, 6])
    _, _, _, _, _, task, batch = _cohorts(ids, tau=3)
    a = tbackend.SerialBackend(device=CPU).run_cohort(task, batch).updates
    b = tbackend.VmapBackend(device=CPU).run_cohort(task, batch).updates
    for la, lb in zip(a, b):
        for k in ("w", "b"):
            torch.testing.assert_close(la[k], lb[k], rtol=0, atol=1e-6)
    w = torch.tensor([0.2, 0.5, 0.3])
    fa = tbackend.SerialBackend(device=CPU).aggregate(a, w)
    fb = tbackend.VmapBackend(device=CPU).aggregate(a, w)
    for la, lb in zip(fa, fb):
        for k in ("w", "b"):
            torch.testing.assert_close(la[k], lb[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["serial", "vmap"])
def test_fedavg_aggregate_params_close(backend):
    ids = np.array([0, 3, 8])
    tj, tp, pj, pt, want, _, _ = _cohorts(ids, tau=2)
    stacked_t = interop.params_from_numpy(_tree_np(want), device=CPU)
    p_k = tj.p_k[ids]
    jagg = japi.get_aggregator("fedavg", backend=japi.get_backend(backend))
    tagg_ = tagg.get_aggregator("fedavg", backend=tbackend.get_backend(backend, CPU))
    new_j, _ = jagg.aggregate_params(pj, want, jnp.asarray(p_k), None)
    new_t, _ = tagg_.aggregate_params(pt, stacked_t, torch.from_numpy(p_k), None)
    _assert_params_close(new_j, new_t, atol=1e-6)
    # the generic delta-space rule lands on the same params
    gen_t, _ = tagg.Aggregator.aggregate_params(tagg_, pt, stacked_t, torch.from_numpy(p_k),
                                                None)
    _assert_params_close(new_j, gen_t, atol=1e-6)


def test_stacked_delta_norms_match():
    ids = np.array([0, 1, 2, 5])
    _, _, pj, pt, want, _, _ = _cohorts(ids, tau=2)
    from repro.api.policy import stacked_delta_norms as jnorms

    stacked_t = interop.params_from_numpy(_tree_np(want), device=CPU)
    np.testing.assert_allclose(tpolicy.stacked_delta_norms(stacked_t, pt),
                               jnorms(want, pj), rtol=1e-12)
    np.testing.assert_allclose(tpolicy.stacked_delta_norms(stacked_t), jnorms(want),
                               rtol=1e-12)


def test_server_folds_match():
    from repro.fed import server as jserver
    from repro_torch.fed import server as tserver

    rng = np.random.default_rng(6)
    cohort = {"w": rng.standard_normal((5, 8, 4)).astype(np.float32),
              "b": rng.standard_normal((5, 6)).astype(np.float32)}
    cohort_t = interop.params_from_numpy(cohort, device=CPU)
    w = rng.uniform(0.1, 1.0, 5).astype(np.float32)
    stale = np.array([0, 1, 3, 0, 7])
    alloc = np.array([0, 2, 2, 1, 2])
    pairs = [
        (jserver.aggregate(cohort, jnp.asarray(w)), tserver.aggregate(cohort_t, torch.from_numpy(w))),
        (jserver.aggregate_stale(cohort, w, stale, 0.5),
         tserver.aggregate_stale(cohort_t, torch.from_numpy(w), torch.from_numpy(stale), 0.5)),
    ]
    for want, got in pairs:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tserver.staleness_weights(torch.from_numpy(w), torch.from_numpy(stale), 0.5).numpy(),
        np.asarray(jserver.staleness_weights(w, stale, 0.5)), rtol=1e-6)
    np.testing.assert_array_equal(
        tserver.selection_weights(torch.from_numpy(alloc), 2, torch.from_numpy(w)).numpy(),
        np.asarray(jserver.selection_weights(jnp.asarray(alloc), 2, jnp.asarray(w))))
