"""The stateful policies, the bid models and the incentive mechanisms, bit
for bit against the JAX package.

One fixed sequence of ``RoundObservation``s goes to both packages'
``ucb_bandit``, ``thompson`` and ``grad_norm``: the allocations must be
identical at every round, and so must the JSON state, which must also
restore a fresh port policy mid-sequence. ``draw_bids`` and
``build_eligibility`` are identical for every bid model and mechanism,
and the ``one_shot`` / ``periodic_auction`` ledgers agree over 30 rounds
down to an exhausted budget. Option errors carry the reference's text.
"""
import json

import numpy as np
import pytest

import repro.api as japi
from repro.api import policy as j_policy
import repro_torch.api as tapi
from repro_torch.api import policy as t_policy

NAMES = ["synth-mnist", "synth-cifar", "synth-fmnist"]
POLICIES = [("ucb_bandit", {}), ("ucb_bandit", {"c": 0.5, "epsilon": 0.2}),
            ("thompson", {}), ("thompson", {"scale": 0.2, "epsilon": 0.0, "seed": 7}),
            ("grad_norm", {}), ("grad_norm", {"gamma": 1.0, "floor": 0.0})]


def _observations(rounds=25, S=3, seed=0):
    """A fixed feedback sequence: losses drifting down with noise, some
    tasks left out of some rounds, a never-reported (inf) loss at first,
    and norms with NaN where a task got no clients."""
    rng = np.random.default_rng(seed)
    losses = np.full(S, np.inf)
    out = []
    for r in range(rounds):
        counts = rng.integers(0, 4, S)
        if r > 0:
            losses = np.where(counts > 0, rng.uniform(0.05, 0.9, S), losses)
        norms = np.where(counts > 0, rng.uniform(0.01, 2.0, S), np.nan)
        out.append((losses.copy(), counts, norms))
    return out


def _context(api, r, losses, S=3):
    return api.RoundContext(round=r, task_names=NAMES[:S], losses=losses, alpha=3.0,
                            n_clients=20)


def _obs(api, r, losses, counts, norms, S=3):
    return api.RoundObservation(round=r, task_names=NAMES[:S], losses=losses,
                                alloc_counts=counts, update_norms=norms)


@pytest.mark.parametrize("name,options", POLICIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(POLICIES)])
def test_policy_allocations_match_reference(name, options):
    pj = japi.POLICIES.get(name)(**options)
    pt = tapi.POLICIES.get(name)(**options)
    assert pt.wants_update_norms == pj.wants_update_norms
    for r, (losses, counts, norms) in enumerate(_observations()):
        want = pj.allocate(_context(japi, r, losses))
        got = pt.allocate(_context(tapi, r, losses))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        pj.observe(_obs(japi, r, losses, counts, norms))
        pt.observe(_obs(tapi, r, losses, counts, norms))
        assert json.dumps(pt.state_dict()) == json.dumps(pj.state_dict())


@pytest.mark.parametrize("name,options", POLICIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(POLICIES)])
def test_policy_state_dict_round_trips(name, options):
    """State written mid-run restores a fresh policy, which then continues
    as the uninterrupted one; loading the never-observed state resets."""
    seq = _observations(rounds=16, seed=3)
    p = tapi.POLICIES.get(name)(**options)
    fresh0 = p.state_dict()
    for r, (losses, counts, norms) in enumerate(seq[:8]):
        p.allocate(_context(tapi, r, losses))
        p.observe(_obs(tapi, r, losses, counts, norms))
    resumed = tapi.POLICIES.get(name)(**options)
    resumed.load_state(json.loads(json.dumps(p.state_dict())))
    for r, (losses, counts, norms) in enumerate(seq[8:], start=8):
        np.testing.assert_array_equal(resumed.allocate(_context(tapi, r, losses)),
                                      p.allocate(_context(tapi, r, losses)))
        p.observe(_obs(tapi, r, losses, counts, norms))
        resumed.observe(_obs(tapi, r, losses, counts, norms))
    p.load_state(fresh0)
    again = tapi.POLICIES.get(name)(**options)
    assert p.state_dict() == again.state_dict()
    losses = seq[3][0]
    np.testing.assert_array_equal(p.allocate(_context(tapi, 0, losses)),
                                  again.allocate(_context(tapi, 0, losses)))


@pytest.mark.parametrize("name,options", [
    ("ucb_bandit", {"epsilon": 1.5}), ("ucb_bandit", {"epsilon": -0.1}),
    ("thompson", {"scale": 0.0}), ("thompson", {"epsilon": 2.0}),
    ("grad_norm", {"gamma": 0.0}), ("grad_norm", {"gamma": 1.5}),
    ("grad_norm", {"floor": -1.0}),
])
def test_policy_option_errors_match_reference(name, options):
    with pytest.raises(ValueError) as ej:
        japi.POLICIES.get(name)(**options)
    with pytest.raises(ValueError) as et:
        tapi.POLICIES.get(name)(**options)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("name", ["ucb_bandit", "thompson", "grad_norm"])
def test_policy_refuses_a_changed_task_count(name):
    p = tapi.POLICIES.get(name)()
    p.allocate(_context(tapi, 0, np.ones(3)))
    with pytest.raises(ValueError, match="task count changed"):
        p.allocate(_context(tapi, 1, np.ones(2), S=2))


@pytest.mark.parametrize("bid_model,S", [("uniform", 2), ("uniform", 3), ("exp4", 2)])
@pytest.mark.parametrize("offset", [0, 7919])
def test_draw_bids_match_reference(bid_model, S, offset):
    aj = japi.AuctionSpec(bid_model=bid_model, bid_seed=4)
    at = tapi.AuctionSpec(bid_model=bid_model, bid_seed=4)
    want = j_policy.draw_bids(aj, 40, S, offset)
    got = t_policy.draw_bids(at, 40, S, offset)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("auction,S,err", [
    (dict(bid_model="exp4"), 3, ValueError),
    (dict(bid_model="lognormal"), 2, KeyError),
    (dict(bids=[[0.1, 0.2]] * 3), 2, ValueError),
])
def test_draw_bids_errors_match_reference(auction, S, err):
    with pytest.raises(err) as ej:
        j_policy.draw_bids(japi.AuctionSpec(**auction), 4, S)
    with pytest.raises(err) as et:
        t_policy.draw_bids(tapi.AuctionSpec(**auction), 4, S)
    assert str(et.value) == str(ej.value)


def test_explicit_bids_are_used_verbatim():
    bids = [[0.3, 0.7], [0.2, 0.2], [0.9, 0.1]]
    np.testing.assert_array_equal(t_policy.draw_bids(tapi.AuctionSpec(bids=bids), 3, 2),
                                  np.asarray(bids))


@pytest.mark.parametrize("mechanism", ["maxmin_fair", "budget_fair", "gmmfair",
                                       "greedy_within_budget", "random_within_budget",
                                       "val_threshold"])
@pytest.mark.parametrize("bid_model,S,budget", [("exp4", 2, 29.0), ("uniform", 3, 6.0),
                                                ("uniform", 2, 0.3)])
def test_build_eligibility_matches_reference(mechanism, bid_model, S, budget):
    kw = dict(mechanism=mechanism, budget=budget, bid_model=bid_model, bid_seed=2)
    ej, rj = j_policy.build_eligibility(japi.AuctionSpec(**kw), 40, S, seed_offset=5)
    et, rt = t_policy.build_eligibility(tapi.AuctionSpec(**kw), 40, S, seed_offset=5)
    np.testing.assert_array_equal(et, ej)
    assert et.dtype == ej.dtype
    assert [[int(u) for u in w] for w in rt.winners] == [[int(u) for u in w]
                                                          for w in rj.winners]
    assert rt.payments == rj.payments and rt.spent == rj.spent
    np.testing.assert_array_equal(rt.take_up, rj.take_up)


@pytest.mark.parametrize("incentive,options,budget", [
    ("one_shot", {}, 20.0),
    ("periodic_auction", {"every": 5}, 20.0),
    ("periodic_auction", {"every": 3}, 2.0),            # exhausts the budget
    ("periodic_auction", {"every": 4, "resample_bids": False}, 8.0),
    ("periodic_auction", {"every": 1}, 0.5),
])
@pytest.mark.parametrize("mechanism", ["gmmfair", "maxmin_fair", "budget_fair"])
def test_incentive_ledgers_match_reference(incentive, options, budget, mechanism):
    kw = dict(mechanism=mechanism, budget=budget, bid_model="exp4", bid_seed=0,
              incentive=incentive, incentive_options=options)
    ij = japi.incentive_from_spec(japi.AuctionSpec(**kw), 40, 2)
    it = tapi.incentive_from_spec(tapi.AuctionSpec(**kw), 40, 2)
    losses = np.array([0.5, 0.7])
    for r in [0, 0] + list(range(1, 30)):           # round 0 asked twice
        uj = ij.recruit(japi.RoundContext(round=r, task_names=NAMES[:2], losses=losses))
        ut = it.recruit(tapi.RoundContext(round=r, task_names=NAMES[:2], losses=losses))
        assert (ut is None) == (uj is None)
        if uj is not None:
            np.testing.assert_array_equal(ut.eligibility, uj.eligibility)
            assert (ut.spent, ut.round) == (uj.spent, uj.round)
        assert (it.spent, it.auctions) == (ij.spent, ij.auctions)
        assert getattr(it, "next_due", None) == getattr(ij, "next_due", None)
        assert it.state_dict() == ij.state_dict()
    assert it.spent <= budget + 1e-9
    if incentive == "periodic_auction" and mechanism != "gmmfair":
        # these spend the whole budget at once: every later due round
        # finds the ledger exhausted and skips
        assert it.auctions == 1 and it.spent == pytest.approx(budget, abs=1e-9)


def test_incentive_state_restores_a_fresh_mechanism():
    kw = dict(mechanism="gmmfair", budget=20.0, bid_model="exp4", incentive="periodic_auction",
              incentive_options={"every": 5})
    a = tapi.incentive_from_spec(tapi.AuctionSpec(**kw), 40, 2)
    for r in range(12):
        a.recruit(tapi.RoundContext(round=r, task_names=NAMES[:2]))
    b = tapi.incentive_from_spec(tapi.AuctionSpec(**kw), 40, 2)
    b.load_state(json.loads(json.dumps(a.state_dict())))
    for r in range(12, 30):
        ua = a.recruit(tapi.RoundContext(round=r, task_names=NAMES[:2]))
        ub = b.recruit(tapi.RoundContext(round=r, task_names=NAMES[:2]))
        assert (ua is None) == (ub is None)
        assert a.state_dict() == b.state_dict()


def test_incentive_option_errors_match_reference():
    kw = dict(incentive="periodic_auction", incentive_options={"every": 0})
    with pytest.raises(ValueError) as ej:
        japi.incentive_from_spec(japi.AuctionSpec(**kw), 4, 2)
    with pytest.raises(ValueError) as et:
        tapi.incentive_from_spec(tapi.AuctionSpec(**kw), 4, 2)
    assert str(et.value) == str(ej.value)
    with pytest.raises(KeyError, match="unknown incentive"):
        tapi.incentive_from_spec(tapi.AuctionSpec(incentive="yearly"), 4, 2)
