"""The sync slice as a whole: the same spec through repro.api.run_scenario
and repro_torch.api.run_scenario(device="cpu") gives identical allocation
traces, accuracies within 1e-3 and final params within 1e-4, for each
legacy strategy. Also the device rule and the refusal of unported spec
features."""
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.interop import params_to_numpy

TASKS = ["synth-mnist", "synth-cifar", "synth-fmnist"]


def _spec(api, strategy="fedfair", **runtime):
    rt = dict(backend="vmap", rounds=4, tau=2)
    rt.update(runtime)
    return api.ScenarioSpec(
        name="parity",
        tasks=[api.TaskSpec(n, options={"n_range": [40, 60], "n_test": 500}) for n in TASKS],
        clients=api.ClientPopulationSpec(n_clients=12, participation=0.5),
        allocation=api.AllocationSpec(strategy=strategy, alpha=3.0),
        runtime=api.RuntimeSpec(**rt))


@pytest.mark.parametrize("strategy", ["fedfair", "random", "round_robin"])
def test_whole_run_matches_reference(strategy):
    rj = japi.run_scenario(_spec(japi, strategy))
    rt = tapi.run_scenario(_spec(tapi, strategy), device="cpu")
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(rt.wall_clock_sim, rj.wall_clock_sim)
    assert rt.task_names == rj.task_names
    assert rt.fairness["worst_task"] == rj.fairness["worst_task"]
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)
    assert all(leaf.device.type == "cpu" for p in rt.params for layer in p
               for leaf in layer.values())
    js = rt.to_json()
    assert js["spec"] == rj.to_json()["spec"]
    assert set(js) == set(rj.to_json())


def test_serial_backend_run_matches_vmap():
    a = tapi.run_scenario(_spec(tapi, backend="serial", rounds=2), device="cpu")
    b = tapi.run_scenario(_spec(tapi, backend="vmap", rounds=2), device="cpu")
    np.testing.assert_array_equal(a.alloc, b.alloc)
    np.testing.assert_allclose(a.acc, b.acc, atol=1e-6, rtol=0)


def test_spec_to_json_round_trips_identically():
    sj, st = _spec(japi), _spec(tapi)
    assert st.to_json() == sj.to_json()
    assert tapi.ScenarioSpec.from_json(st.to_json()).to_json() == st.to_json()


def test_run_scenario_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.run_scenario(_spec(tapi, rounds=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.run_scenario(_spec(tapi, rounds=1), device="cuda")


def _with(spec, **changes):
    for path, value in changes.items():
        obj = spec
        *head, last = path.split("__")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return spec


@pytest.mark.parametrize("changes,item", [
    (dict(runtime__mode="async", clients__population="vectorized"), None),
    (dict(clients__population="vectorized"), None),
    (dict(runtime__checkpoint_dir="ckpt"), None),
    (dict(runtime__backend="sharded"), "vmap"),
], ids=["async", "population", "checkpoint", "sharded"])
def test_unported_feature_raises(changes, item, tmp_path):
    """No spec feature is refused any more: populations (both modes),
    checkpoints and the sharded backend run (once refused naming ROADMAP
    item 14); the sharded run equals the same spec on ``item``'s backend
    within 1e-6, with identical allocation traces."""
    if "runtime__checkpoint_dir" in changes:
        changes = dict(runtime__checkpoint_dir=str(tmp_path / "ckpt"),
                       runtime__checkpoint_every=1)
    spec = _with(_spec(tapi, rounds=1), **changes)
    res = tapi.run_scenario(spec, device="cpu")
    assert np.isfinite(res.acc).all()
    if item is None:
        return
    want = tapi.run_scenario(_with(_spec(tapi, rounds=1), runtime__backend=item), device="cpu")
    np.testing.assert_array_equal(res.alloc, want.alloc)
    np.testing.assert_allclose(res.acc, want.acc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.loss, want.loss, atol=1e-6, rtol=0)


@pytest.mark.parametrize("changes", [
    dict(auction=tapi.AuctionSpec()),
    dict(runtime__cost_model="trace_replay",
         runtime__cost_model_options={"trace": {"latencies": {"*": [1.0, 2.0]}}}),
    dict(runtime__aggregator="fedmedian"),
    dict(policy=tapi.PolicySpec("ucb_bandit")),
], ids=["auction", "cost_model", "aggregator", "policy"])
def test_formerly_refused_feature_runs(changes):
    """Auctions, the remaining cost models, aggregators and policies are
    ported; tests/test_torch_incentives.py holds them against the
    reference."""
    res = tapi.run_scenario(_with(_spec(tapi, rounds=1), **changes), device="cpu")
    assert res.alloc_counts.shape == (1, 3)
    assert (res.auction is not None) == ("auction" in changes)


def test_arch_family_raises():
    """The arch family runs (tests/test_torch_train.py), phi-3-vision too
    (once refused naming ROADMAP item 10): its run gives the reference's
    allocation trace and accuracies, and losses within 1e-4."""
    def spec(api):
        return api.ScenarioSpec(
            tasks=[api.TaskSpec("phi-3-vision-4.2b", family="arch",
                                options={"preset": "tiny", "seq": 24, "batch": 2})],
            clients=api.ClientPopulationSpec(n_clients=4, participation=0.5),
            runtime=api.RuntimeSpec(rounds=2, tau=1))

    rt = tapi.run_scenario(spec(tapi), device="cpu")
    rj = japi.run_scenario(spec(japi))
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    np.testing.assert_array_equal(rt.acc, rj.acc)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-4, rtol=0)


def test_legacy_policy_spec_runs():
    spec = _with(_spec(tapi, rounds=1), policy=tapi.PolicySpec("round_robin"))
    assert tapi.run_scenario(spec, device="cpu").alloc_counts.shape == (1, 3)


@pytest.mark.cuda
def test_slice_on_cuda_launches_kernel_once_per_fold():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    from repro_torch.kernels import LAUNCHES, reset_launches

    spec = _spec(tapi, "round_robin")
    reset_launches()
    gpu = tapi.run_scenario(spec)
    assert LAUNCHES["fedavg"] == int((gpu.alloc_counts > 0).sum())
    assert all(leaf.device.type == "cuda" for p in gpu.params for layer in p
               for leaf in layer.values())
    cpu = tapi.run_scenario(spec, device="cpu")
    np.testing.assert_array_equal(gpu.alloc, cpu.alloc)
    np.testing.assert_allclose(gpu.acc, cpu.acc, atol=0.01, rtol=0)
