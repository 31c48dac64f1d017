"""Client populations in the port against the JAX package's.

The numpy parts are bit-equal with the reference: every registered
arrival process's batched ``next_starts`` draws its stream as the scalar
loop does and as the reference's does; speeds, the shared-memory
eligibility view, bids and ``LazyFedTask`` shards equal the reference's.
Enabling the ``vectorized`` population changes nothing in a port run
(bit-exact traces and curves, sync and async). The port and the reference
give identical allocation and event traces on the same population spec,
``examples/specs/big_population.json`` (100,000 lazy clients) included,
with accuracies within 1e-3. A 10,000-client lazy async run resumes event
for event.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.pop as jpop
import repro_torch.api as tapi
import repro_torch.pop as tpop
from repro_torch.interop import params_to_numpy

ROOT = Path(__file__).resolve().parents[1]
TRACE = ("time", "versions", "arrivals", "buffer_sizes", "staleness_mean", "dropped",
         "cost_dropouts")



@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a shared CPU, where each process's full thread pool
    oversubscribes the cores and these small runs spin rather than
    compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(api, population=None, mode="sync", n_clients=10, **kw):
    return api.ScenarioSpec(
        name="pop-parity", seed=3, data_seed=5,
        tasks=[api.TaskSpec("synth-mnist", options={"n_range": [40, 60]}),
               api.TaskSpec("synth-fmnist", options={"n_range": [40, 60]})],
        clients=api.ClientPopulationSpec(
            n_clients=n_clients, participation=0.6, speed_profile="bimodal",
            arrival_process=kw.pop("arrival_process", "poisson"),
            arrival_options=kw.pop("arrival_options", {"mean_idle": 0.5}),
            population=population, population_options=kw.pop("population_options", {})),
        policy=kw.pop("policy", None),
        auction=kw.pop("auction", None),
        runtime=api.RuntimeSpec(mode=mode, rounds=3, tau=2,
                                total_arrivals=kw.pop("total_arrivals", 30), buffer_size=3,
                                **kw))


def _run(api, spec):
    return api.run_scenario(spec, device="cpu") if api is tapi else api.run_scenario(spec)


def _assert_sync_equal(a, b):
    for key in ("loss", "acc", "alloc", "alloc_counts", "wall_clock_sim"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


def _assert_async_equal(a, b):
    for key in TRACE + ("loss", "acc"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    assert a.assignments == b.assignments


def _assert_matches_reference(rt, rj):
    """Port against reference: identical traces, accuracies within 1e-3,
    final params within 1e-4."""
    if rt.mode == "sync":
        for key in ("alloc", "alloc_counts", "wall_clock_sim"):
            np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
    else:
        for key in TRACE:
            np.testing.assert_array_equal(getattr(rt, key), getattr(rj, key), err_msg=key)
        assert rt.assignments == rj.assignments
    np.testing.assert_allclose(rt.acc, rj.acc, atol=1e-3, rtol=0)
    assert rt.auction == rj.auction
    for pj, pt in zip(rj.params, params_to_numpy(rt.params)):
        for lj, lt in zip(pj, pt):
            for k in ("w", "b"):
                np.testing.assert_allclose(lt[k], np.asarray(lj[k]), atol=1e-4, rtol=0)


# ---------------------------------------------- the numpy parts, bit-equal

@pytest.mark.parametrize("name", sorted(tapi.ARRIVAL_PROCESSES.names()))
def test_next_starts_matches_scalar_loop_and_reference(name):
    """For every registered process: the batched draw equals the scalar
    loop on the same stream and the reference's batched draw, across
    repeated batches that advance the stream."""
    procs = [tapi.ARRIVAL_PROCESSES.get(name)(), tapi.ARRIVAL_PROCESSES.get(name)(),
             japi.ARRIVAL_PROCESSES.get(name)()]
    K = 16
    for p in procs:
        p.reset(K, np.random.default_rng(7))
    t = 0.0
    for batch in (np.arange(K), np.array([3, 1, 9]), np.arange(5, 11)):
        scalar = np.array([procs[0].next_start(int(c), t) for c in batch])
        vector = procs[1].next_starts(batch, t)
        ref = procs[2].next_starts(batch, t)
        np.testing.assert_array_equal(scalar, vector)
        np.testing.assert_array_equal(vector, ref)
        t += 1.7
    assert json.dumps(procs[1].state_dict()) == json.dumps(procs[2].state_dict())


@pytest.mark.parametrize("profile", ["uniform", "bimodal", "lognormal"])
def test_population_speeds_and_streams_equal_reference(profile):
    kw = dict(n_clients=64, n_tasks=3, seed=9, speed_profile=profile, speed_spread=4.0,
              arrival_process="poisson", cost_model="lognormal_straggler",
              cost_model_options={"sigma": 0.4, "dropout_prob": 0.1})
    tp = tpop.get_population("vectorized", {}, **kw)
    jp = jpop.get_population("vectorized", {}, **kw)
    np.testing.assert_array_equal(tp.speeds, jp.speeds)
    for p in (tp, jp):
        p.cost_model.reset(64, 3, np.random.default_rng(12))
    ids = np.array([5, 2, 40, 63])
    np.testing.assert_array_equal(tp.next_arrivals(ids, 2.5), jp.next_arrivals(ids, 2.5))
    for a, b in zip(tp.sample_latencies(ids, [0, 1, 2, 0], 1.5, times=1.0),
                    jp.sample_latencies(ids, [0, 1, 2, 0], 1.5, times=1.0)):
        np.testing.assert_array_equal(a, b)
    assert tp.config_record() == jp.config_record()


def test_eligibility_view_shares_memory_and_state_roundtrips():
    """The engine-held (N, S) view writes through to the (S, N) arrays, and
    the state (packed eligibility, streams) round-trips through JSON into
    the reference's population and back."""
    tp = tpop.get_population("vectorized", {}, n_clients=6, n_tasks=2, seed=0,
                             arrival_process="bursty")
    view = tp.set_eligibility(np.ones((6, 2), bool))
    view[4, 1] = False
    assert not tp.eligibility[4, 1] and not tp._elig[1, 4]
    assert np.shares_memory(view, tp._elig)
    state = json.loads(json.dumps(tp.state_dict()))
    jp = jpop.get_population("vectorized", {}, n_clients=6, n_tasks=2, seed=5,
                             arrival_process="bursty")
    jp.load_state(state)
    np.testing.assert_array_equal(jp.eligibility, tp.eligibility)
    assert json.dumps(jp.state_dict()) == json.dumps(tp.state_dict())
    ids = np.arange(6)
    np.testing.assert_array_equal(jp.next_arrivals(ids, 3.0), tp.next_arrivals(ids, 3.0))


def test_population_bids_equal_reference():
    auction = tapi.AuctionSpec(mechanism="gmmfair", budget=6.0, bid_seed=11)
    jauction = japi.AuctionSpec(mechanism="gmmfair", budget=6.0, bid_seed=11)
    tp = tpop.get_population("vectorized", {}, n_clients=12, n_tasks=3, seed=0)
    jp = jpop.get_population("vectorized", {}, n_clients=12, n_tasks=3, seed=0)
    np.testing.assert_array_equal(tp.bids(auction), jp.bids(jauction))


def test_lazy_task_equals_reference():
    """Sizes, weights, the test set and every gathered shard (any order,
    through the LRU cache) are bit-equal with the reference's."""
    kw = dict(n_range=(40, 60), warp_depth=2, label_noise=0.1, cache_rows=3)
    tt = tpop.LazyFedTask(7, "synth-mnist", 50, **kw)
    jt = jpop.LazyFedTask(7, "synth-mnist", 50, **kw)
    assert tt.train_x.shape == jt.train_x.shape
    np.testing.assert_array_equal(tt.p_k, jt.p_k)
    np.testing.assert_array_equal(tt.test_x, jt.test_x)
    np.testing.assert_array_equal(tt.test_y, jt.test_y)
    for ids in ([2, 49, 0], [49, 7, 2, 31], [0]):
        for a, b in zip(tt.gather(np.array(ids)), jt.gather(np.array(ids))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    x, _, w = tt.gather(np.array([2]))
    assert (w[0, int(tt._sizes[2]):] == 0).all() and (w[0, :int(tt._sizes[2])] == 1).all()
    assert len(tt._cache) == 3


# ------------------------------------------- the port's own parity (bit-exact)

def test_sync_population_parity_with_cost_model():
    legacy = _run(tapi, _spec(tapi, None, cost_model="device_tiers"))
    pop = _run(tapi, _spec(tapi, "vectorized", cost_model="device_tiers"))
    _assert_sync_equal(legacy, pop)


def test_async_population_parity_straggler_poisson():
    kw = dict(mode="async", cost_model="lognormal_straggler",
              cost_model_options={"sigma": 0.5, "dropout_prob": 0.1})
    legacy = _run(tapi, _spec(tapi, None, **kw))
    pop = _run(tapi, _spec(tapi, "vectorized", **kw))
    _assert_async_equal(legacy, pop)
    assert legacy.cost_dropouts == pop.cost_dropouts


def _bursty_auction(api):
    return dict(mode="async", arrival_process="bursty",
                arrival_options={"period": 2.0, "duty": 0.6},
                policy=api.PolicySpec("ucb_bandit", {"epsilon": 0.3}),
                auction=api.AuctionSpec(mechanism="gmmfair", budget=8.0, bid_seed=0,
                                        incentive="periodic_auction",
                                        incentive_options={"every": 3}))


def test_async_population_parity_bursty_periodic_auction():
    legacy = _run(tapi, _spec(tapi, None, **_bursty_auction(tapi)))
    pop = _run(tapi, _spec(tapi, "vectorized", **_bursty_auction(tapi)))
    _assert_async_equal(legacy, pop)
    assert legacy.auction == pop.auction


# ------------------------------------------- the port against the reference

@pytest.mark.parametrize("case", ["sync-tiers", "async-straggler", "async-bursty-auction"])
def test_population_runs_match_reference(case):
    def build(api):
        if case == "sync-tiers":
            return _spec(api, "vectorized", cost_model="device_tiers")
        if case == "async-straggler":
            return _spec(api, "vectorized", mode="async", cost_model="lognormal_straggler",
                         cost_model_options={"sigma": 0.5, "dropout_prob": 0.1})
        return _spec(api, "vectorized", **_bursty_auction(api))

    _assert_matches_reference(_run(tapi, build(tapi)), _run(japi, build(japi)))


def test_big_population_spec_matches_reference():
    """Acceptance: examples/specs/big_population.json as written (100,000
    clients, lazy shards, 2 rounds) runs in the port and matches the
    reference's allocation trace and accuracies."""
    path = ROOT / "examples" / "specs" / "big_population.json"
    rt = tapi.run_scenario(tapi.ScenarioSpec.load(str(path)), device="cpu")
    rj = japi.run_scenario(japi.ScenarioSpec.load(str(path)))
    assert rt.alloc.shape == (2, 100_000)
    _assert_matches_reference(rt, rj)


def test_lazy_async_population_matches_reference():
    def build(api):
        return _spec(api, "vectorized", mode="async", n_clients=2000,
                     population_options={"lazy_data": True}, total_arrivals=24)

    _assert_matches_reference(_run(tapi, build(tapi)), _run(japi, build(japi)))


# -------------------------------------------------------------- refusals

def test_population_options_without_name_rejected():
    with pytest.raises(ValueError, match="population_options"):
        _run(tapi, _spec(tapi, None, population_options={"lazy_data": True}))


def test_unknown_population_rejected():
    with pytest.raises(KeyError, match="nope"):
        _run(tapi, _spec(tapi, "nope"))


def test_bad_population_options_rejected():
    with pytest.raises(ValueError, match="bad options for population"):
        _run(tapi, _spec(tapi, "vectorized", population_options={"warp_factor": 9}))


# ---------------------------------------------------------- resume at scale

def test_population_async_resume_10k_clients_lazy(tmp_path):
    """A 10,000-client async run with lazy shards checkpoints mid-run and
    resumes event for event as the uninterrupted run."""
    def spec(ckpt_dir=None, resume=False):
        return tapi.ScenarioSpec(
            name="pop-10k", seed=1,
            tasks=[tapi.TaskSpec("synth-mnist", options={"n_range": [40, 60]})],
            clients=tapi.ClientPopulationSpec(n_clients=10_000, speed_profile="bimodal",
                                              population="vectorized",
                                              population_options={"lazy_data": True}),
            runtime=tapi.RuntimeSpec(mode="async", tau=1, total_arrivals=24, buffer_size=4,
                                     checkpoint_dir=ckpt_dir, checkpoint_every=4,
                                     resume=resume))

    d = str(tmp_path / "ck")
    full = _run(tapi, spec())
    _assert_async_equal(full, _run(tapi, spec(ckpt_dir=d)))
    latest = int(open(f"{d}/LATEST").read())
    assert 0 < latest < len(full.time)
    _assert_async_equal(full, _run(tapi, spec(ckpt_dir=d, resume=True)))


def test_population_config_mismatch_on_resume_raises(tmp_path):
    def spec(options, resume=False):
        return _spec(tapi, "vectorized", mode="async", population_options=options,
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2, resume=resume)

    _run(tapi, spec({"cache_rows": 64}))
    with pytest.raises(ValueError, match="population options"):
        _run(tapi, spec({"cache_rows": 128}, resume=True))
