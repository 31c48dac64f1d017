"""The recruitment auctions and the theory objects, bit for bit against the
JAX package.

Every mechanism of ``core/auctions.py`` runs on the same seeded bid
matrices through both packages' ``AUCTIONS`` registries: winners,
payments, fractional shares, take-up and spend must be identical. The
bids are rounded to one decimal, so ties are common and the stable
argsorts decide the winners. ``core/theory.py`` is held within 1e-12, and
``examples/auction_recruitment.py`` prints the same table against both
packages.
"""
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
from repro.core import auctions as j_auctions
from repro.core import theory as j_theory
import repro_torch.api as tapi
from repro_torch.core import auctions as t_auctions
from repro_torch.core import theory as t_theory

ROOT = Path(__file__).resolve().parents[1]
MECHANISMS = ("maxmin_fair", "budget_fair", "gmmfair", "greedy_within_budget",
              "random_within_budget", "val_threshold")


def _bids(n, S, seed):
    rng = np.random.default_rng(seed)
    return np.round(rng.uniform(0.05, 1.0, (n, S)), 1)


def _same_result(got, want):
    assert [[int(u) for u in w] for w in got.winners] == \
        [[int(u) for u in w] for w in want.winners]
    assert got.payments == want.payments
    assert got.fractional == want.fractional
    np.testing.assert_array_equal(got.take_up, want.take_up)
    assert got.take_up.dtype == want.take_up.dtype
    assert got.spent == want.spent
    assert got.min_take_up == want.min_take_up
    assert got.diff_take_up == want.diff_take_up


@pytest.mark.parametrize("budget", [0.05, 1.0, 5.0, 50.0],
                         ids=["starved", "tight", "middle", "ample"])
@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("n", [1, 7, 40])
@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_mechanism_matches_reference(mechanism, n, S, budget):
    bids = _bids(n, S, seed=1000 * n + 10 * S + int(budget * 100))
    opts = {"threshold": 0.4} if mechanism == "val_threshold" else {}
    want = japi.AUCTIONS.get(mechanism)(bids.copy(), budget,
                                        rng=np.random.default_rng(3), **opts)
    got = tapi.AUCTIONS.get(mechanism)(bids.copy(), budget,
                                       rng=np.random.default_rng(3), **opts)
    _same_result(got, want)


@pytest.mark.parametrize("fn", ["budget_fair_auction", "gmmfair", "maxmin_fair_auction",
                                "greedy_within_budget"])
def test_all_ties_pick_the_same_winners(fn):
    """Every bid equal: only the stable argsort decides who wins."""
    bids = np.full((12, 3), 0.5)
    _same_result(getattr(t_auctions, fn)(bids, 4.0), getattr(j_auctions, fn)(bids, 4.0))


def test_random_within_budget_consumes_the_same_stream():
    bids = _bids(30, 2, seed=9)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    _same_result(t_auctions.random_within_budget(rt, bids, 6.0),
                 j_auctions.random_within_budget(rj, bids, 6.0))
    assert rt.bit_generator.state == rj.bit_generator.state


def test_registry_keys_are_the_same_set():
    assert set(tapi.AUCTIONS.names()) == set(japi.AUCTIONS.names())
    assert set(tapi.INCENTIVES.names()) == set(japi.INCENTIVES.names())


@pytest.mark.parametrize("losses,alpha", [([0.2, 0.5, 0.9], 3.0), ([0.4, 0.4], 1.0),
                                          ([0.05, 0.3, 0.6, 0.95], 5.0)])
def test_theory_matches_reference(losses, alpha):
    for s in range(len(losses)):
        assert t_theory.task_selection_prob(losses, alpha, s) == pytest.approx(
            j_theory.task_selection_prob(losses, alpha, s), abs=1e-12, rel=0)
        assert t_theory.corollary5_term(losses, alpha, s, 20) == pytest.approx(
            j_theory.corollary5_term(losses, alpha, s, 20), abs=1e-12, rel=0)
    np.testing.assert_allclose(t_theory.expected_allocation(losses, alpha, 40),
                               j_theory.expected_allocation(losses, alpha, 40),
                               atol=1e-12, rtol=0)
    args = dict(T=50, gamma=8.0, tau=3, G2=1.5, sigma2=0.3, rho_bar=0.4, rho_tilde=0.5,
                L=2.0, mu=0.5, Gamma_s=0.1, w0_dist=4.0)
    assert t_theory.convergence_bound(**args) == pytest.approx(
        j_theory.convergence_bound(**args), abs=1e-12, rel=0)


def _example_output(auction_module) -> str:
    """Run examples/auction_recruitment.py's ``main`` with its auction
    functions taken from ``auction_module``; return what it prints."""
    spec = importlib.util.spec_from_file_location("auction_recruitment",
                                                  ROOT / "examples" / "auction_recruitment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("budget_fair_auction", "gmmfair", "greedy_within_budget",
                 "maxmin_fair_auction", "random_within_budget", "val_threshold"):
        setattr(mod, name, getattr(auction_module, name))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def test_auction_recruitment_example_is_the_same():
    want = _example_output(j_auctions)
    assert "MMFL Max-Min Fair" in want
    assert _example_output(t_auctions) == want
