"""The slice as a whole: auctions, incentives, the stateful policies, the
robust aggregators and the heavy-tailed cost models through both
``run_scenario``s, and ``sweep_scenarios``.

The same spec goes to ``repro.api.run_scenario`` and to
``repro_torch.api.run_scenario(device="cpu")``. Sync runs must give
identical allocation traces, an identical ``RunResult.auction`` and
accuracies within 1e-3; async runs identical event traces and
``cost_dropouts``; both final params within 1e-4. Runs at the shapes of
``benchmarks/experiments.py`` exp5, exp11, exp13 and exp14, cut to a few
rounds or arrivals. The spec features of later slices still raise.
"""
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro_torch.api as tapi
from repro_torch.interop import params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
TRACE = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
         "cost_dropouts")
LOGNORMAL = {"sigma": 0.6, "straggler_frac": 0.25, "straggler_factor": 4.0,
             "dropout_prob": 0.05}                      # exp14


def _params_close(rt, rj):
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)


def _assert_sync_match(rt, rj):
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    np.testing.assert_array_equal(rt.alloc_counts, rj.alloc_counts)
    np.testing.assert_array_equal(rt.wall_clock_sim, rj.wall_clock_sim)
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    assert rt.auction == rj.auction
    _params_close(rt, rj)
    js, jj = rt.to_json(), rj.to_json()
    assert set(js) == set(jj) and js["spec"] == jj["spec"]


def _assert_async_match(rt, rj):
    for key in TRACE:
        np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
    assert rt.assignments == rj.assignments
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    assert rt.auction == rj.auction
    _params_close(rt, rj)
    js, jj = rt.to_json(), rj.to_json()
    assert set(js) == set(jj) and js["spec"] == jj["spec"]


def _both(build):
    """Run ``build(api)`` through both packages; returns (port, reference)."""
    return tapi.run_scenario(build(tapi), device="cpu"), japi.run_scenario(build(japi))


def test_ucb_periodic_example_spec_matches_reference():
    path = str(ROOT / "examples" / "specs" / "ucb_periodic.json")
    rt, rj = _both(lambda api: api.ScenarioSpec.load(path))
    _assert_sync_match(rt, rj)
    assert rt.auction["incentive"] == "periodic_auction" and rt.auction["auctions_run"] == 2


def _sync(api, *, policy=None, auction=None, aggregator=None, agg_opts=None, cost_model=None,
          cost_opts=None, names=("synth-mnist", "synth-cifar"), n_clients=16,
          participation=0.6, rounds=4, strategy="fedfair"):
    return api.ScenarioSpec(
        name="slice6-sync", seed=0, data_seed=0,
        tasks=[api.TaskSpec(n, options={"n_range": [60, 90], "n_test": 300}) for n in names],
        clients=api.ClientPopulationSpec(n_clients=n_clients, participation=participation),
        allocation=api.AllocationSpec(strategy=strategy, alpha=3.0),
        policy=None if policy is None else api.PolicySpec(*policy),
        auction=None if auction is None else api.AuctionSpec(**auction),
        runtime=api.RuntimeSpec(backend="vmap", rounds=rounds, tau=3, aggregator=aggregator,
                                aggregator_options=dict(agg_opts or {}), cost_model=cost_model,
                                cost_model_options=dict(cost_opts or {})))


EXP5 = dict(budget=29.0, bid_model="exp4", bid_seed=0)
SYNC_CASES = {
    "exp5-maxmin_fair": dict(auction=dict(mechanism="maxmin_fair", **EXP5)),
    "exp5-budget_fair": dict(auction=dict(mechanism="budget_fair", **EXP5)),
    "exp11-ucb_bandit": dict(policy=("ucb_bandit", {"epsilon": 0.2}), participation=0.25,
                             names=("synth-mnist", "synth-cifar", "synth-fmnist"), n_clients=20),
    "exp11-grad_norm": dict(policy=("grad_norm", {}), participation=0.25,
                            names=("synth-mnist", "synth-cifar", "synth-fmnist"), n_clients=20),
    "exp11-one_shot": dict(auction=dict(mechanism="gmmfair", budget=20.0, bid_model="exp4")),
    "thompson-qfedavg-lognormal": dict(policy=("thompson", {}), aggregator="qfedavg",
                                       agg_opts={"q": 1.0}, cost_model="lognormal_straggler",
                                       cost_opts=LOGNORMAL),
    "fedmedian-trace_replay": dict(aggregator="fedmedian", cost_model="trace_replay",
                                   cost_opts={"trace": {"latencies": {"*": [1.0, 2.5, 0.5]}}}),
    "trimmed_mean-round_robin": dict(aggregator="trimmed_mean", agg_opts={"trim": 0.2},
                                     strategy="round_robin"),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_run_matches_reference(case):
    rt, rj = _both(lambda api: _sync(api, **SYNC_CASES[case]))
    _assert_sync_match(rt, rj)
    if "auction" in SYNC_CASES[case]:
        assert rt.auction["auctions_run"] == 1 and rt.auction["spent"] > 0


def test_sync_run_is_repeatable_with_an_incentive():
    """run() twice gives run() once twice: the trainer reloads the
    incentive's construction-time ledger."""
    spec = _sync(tapi, auction=dict(mechanism="gmmfair", budget=6.0, bid_model="exp4",
                                    incentive="periodic_auction",
                                    incentive_options={"every": 2}), rounds=6)
    runner = tapi.TASK_FAMILIES.get("synthetic")()
    inc = tapi.incentive_from_spec(spec.auction, 16, 2)
    upd = inc.recruit(tapi.RoundContext(round=0, task_names=["a", "b"], n_clients=16))
    engine = runner.sync_engine(spec, upd.eligibility, inc, device="cpu")
    a, b = engine.run(), engine.run()
    np.testing.assert_array_equal(a.alloc, b.alloc)
    np.testing.assert_array_equal(a.acc, b.acc)
    assert inc.auctions == 3


def _async(api, *, aggregator=None, agg_opts=None, cost_model=None, cost_opts=None,
           policy=None, auction=None, arrivals=36, strategy="fedfair", spread=8.0):
    return api.ScenarioSpec(
        name="slice6-async", seed=0, data_seed=0,
        tasks=[api.TaskSpec(n, options={"n_range": [60, 90], "n_test": 300})
               for n in ("synth-mnist", "synth-fmnist")],
        clients=api.ClientPopulationSpec(n_clients=8, speed_profile="bimodal",
                                         speed_spread=spread),
        allocation=api.AllocationSpec(strategy=strategy, alpha=3.0),
        policy=None if policy is None else api.PolicySpec(*policy),
        auction=None if auction is None else api.AuctionSpec(**auction),
        runtime=api.RuntimeSpec(mode="async", backend="vmap", tau=3, total_arrivals=arrivals,
                                buffer_size=3, beta=0.5, aggregator=aggregator,
                                aggregator_options=dict(agg_opts or {}),
                                cost_model=cost_model, cost_model_options=dict(cost_opts or {})))


ASYNC_CASES = {
    "exp13-fedmedian": dict(aggregator="fedmedian"),
    "exp13-trimmed_mean": dict(aggregator="trimmed_mean", agg_opts={"trim": 0.2}),
    "exp13-qfedavg": dict(aggregator="qfedavg", agg_opts={"q": 1.0}),
    "exp14-lognormal-thompson": dict(cost_model="lognormal_straggler", cost_opts=LOGNORMAL,
                                     policy=("thompson", {}), spread=4.0, arrivals=48),
    "exp14-lognormal-ucb_bandit": dict(cost_model="lognormal_straggler", cost_opts=LOGNORMAL,
                                       policy=("ucb_bandit", {}), spread=4.0),
    "trace_replay-grad_norm": dict(
        cost_model="trace_replay", policy=("grad_norm", {}),
        cost_opts={"trace": {"latencies": {"0": [3.0], "*": [1.0, 0.4]}}}),
    "periodic_auction": dict(auction=dict(mechanism="gmmfair", budget=4.0, bid_model="exp4",
                                          incentive="periodic_auction",
                                          incentive_options={"every": 3})),
}


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_async_run_matches_reference(case):
    rt, rj = _both(lambda api: _async(api, **ASYNC_CASES[case]))
    assert len(rt.time) >= 5
    _assert_async_match(rt, rj)
    if case.startswith("exp14-lognormal-thompson"):
        assert rt.cost_dropouts > 0
    if case == "periodic_auction":
        assert rt.auction["auctions_run"] > 1


def _sweep_base():
    return _sync(tapi, rounds=2, n_clients=8, names=("synth-mnist",))


SWEEP_GRID = {"allocation.alpha": [1.0, 3.0], "runtime.aggregator": ["fedmedian", "qfedavg"]}


def _strip_wall_times(payload):
    for run in payload["runs"]:
        run.pop("wall_time")
        run["result"].pop("wall_time")
    return payload


def test_sweep_sequential_equals_parallel():
    seq = tapi.sweep_scenarios(_sweep_base(), SWEEP_GRID, device="cpu")
    par = tapi.sweep_scenarios(_sweep_base(), SWEEP_GRID, device="cpu", max_workers=2)
    assert [r["name"] for r in seq["runs"]] == [
        "slice6-sync/alpha=1.0-aggregator=fedmedian", "slice6-sync/alpha=1.0-aggregator=qfedavg",
        "slice6-sync/alpha=3.0-aggregator=fedmedian", "slice6-sync/alpha=3.0-aggregator=qfedavg"]
    assert _strip_wall_times(seq) == _strip_wall_times(par)


def test_sweep_payload_matches_reference():
    base_j = _sync(japi, rounds=2, n_clients=8, names=("synth-mnist",))
    grid = {"runtime.aggregator": ["fedmedian", "trimmed_mean"]}
    want = _strip_wall_times(japi.sweep_scenarios(base_j, grid))
    got = _strip_wall_times(tapi.sweep_scenarios(_sweep_base(), grid, device="cpu"))
    assert got["base"] == want["base"] and got["grid"] == want["grid"]
    for g, w in zip(got["runs"], want["runs"]):
        assert (g["name"], g["overrides"]) == (w["name"], w["overrides"])
        assert g["result"]["alloc_counts"] == w["result"]["alloc_counts"]
        np.testing.assert_allclose(g["result"]["acc"], w["result"]["acc"], atol=1e-3, rtol=0)


def test_sweep_overrides_fail_fast():
    with pytest.raises(AttributeError, match="has no field 'alpah'"):
        tapi.apply_override(_sweep_base(), "allocation.alpah", 2.0)
    with pytest.raises(TypeError, match="must be a list"):
        tapi.sweep_scenarios(_sweep_base(), {"seed": 3}, device="cpu")


def _with(spec, **changes):
    for path, value in changes.items():
        obj = spec
        *head, last = path.split("__")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    return spec


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("changes,item", [
    (dict(clients__population="vectorized"), None),
    (dict(runtime__checkpoint_dir="ckpt"), None),
    (dict(runtime__backend="sharded"), "vmap"),
], ids=["population", "checkpoint", "sharded"])
def test_remaining_refusals_still_raise(mode, changes, item, tmp_path):
    """Nothing is refused any more: a population, checkpoints and the
    sharded backend (once refused naming ROADMAP item 14) run with an
    auction in both modes; the sharded run equals the same spec on
    ``item``'s backend within 1e-6, with the same auction and traces."""
    if "runtime__checkpoint_dir" in changes:
        changes = dict(runtime__checkpoint_dir=str(tmp_path / "ckpt"),
                       runtime__checkpoint_every=1)

    def spec_with(**extra):
        return _with(_async(tapi, arrivals=4, auction=dict(mechanism="gmmfair", **EXP5)),
                     runtime__mode=mode, **extra)

    res = tapi.run_scenario(spec_with(**changes), device="cpu")
    assert res.auction is not None and np.isfinite(res.acc).all()
    if item is None:
        return
    want = tapi.run_scenario(spec_with(runtime__backend=item), device="cpu")
    assert res.auction == want.auction
    np.testing.assert_array_equal(res.alloc, want.alloc)
    np.testing.assert_allclose(res.acc, want.acc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.loss, want.loss, atol=1e-6, rtol=0)


def test_arch_family_with_an_auction_still_raises():
    """The arch family runs with an auction and a policy, phi-3-vision's
    too (once refused naming ROADMAP item 10): the same spec through both
    packages gives the same auction, allocation trace and accuracies, and
    losses within 1e-4."""
    def build(api):
        return api.ScenarioSpec(
            tasks=[api.TaskSpec(a, family="arch",
                                options={"preset": "tiny", "seq": 24, "batch": 2})
                   for a in ("phi-3-vision-4.2b", "smollm-135m")],
            clients=api.ClientPopulationSpec(n_clients=6, participation=0.5),
            auction=api.AuctionSpec(), policy=api.PolicySpec("thompson"),
            runtime=api.RuntimeSpec(rounds=2, tau=1))

    rt, rj = _both(build)
    assert rt.auction is not None and rt.auction == rj.auction
    np.testing.assert_array_equal(rt.alloc, rj.alloc)
    np.testing.assert_array_equal(rt.acc, rj.acc)
    np.testing.assert_allclose(rt.loss, rj.loss, atol=1e-4, rtol=0)


@pytest.mark.parametrize("auction,err,match", [
    (dict(budget=0.0), ValueError, "auction.budget must be positive"),
    (dict(incentive="yearly"), KeyError, "unknown incentive"),
    (dict(mechanism="vickrey"), KeyError, "unknown auction"),
])
def test_auction_spec_errors_match_reference(auction, err, match):
    with pytest.raises(err, match=match) as ej:
        japi.run_scenario(_sync(japi, auction=auction, rounds=1))
    with pytest.raises(err, match=match) as et:
        tapi.run_scenario(_sync(tapi, auction=auction, rounds=1), device="cpu")
    assert str(et.value) == str(ej.value)
