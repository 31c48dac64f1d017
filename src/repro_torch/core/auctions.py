"""Client-incentive auctions for MMFL (paper Section V).

The port's copy of the JAX package's ``core/auctions.py``: numpy only, and
bit-exact with it (every argsort is ``kind="stable"``, so ties pick the
same winners).

Implemented mechanisms (all operate on a bid matrix ``bids[i, s]`` = user
i's asked payment for training task s, and a total budget B):

  * ``budget_fair_auction``  — Section V-A: per-task proportional-share
    auction (Singer 2014) with equal budget B/S per task. Truthful.
  * ``gmmfair``              — Algorithm 2: greedy max-min fair allocation.
    Optimal for (14) but NOT truthful (winners are paid their bids).
  * ``maxmin_fair_auction``  — Algorithm 3: round-based budget-fair auction
    with cross-task budget re-allocation (waterfilling) and a terminal
    fractional round. Near-truthful (Thm. 8 / Cor. 9).
  * baselines from Experiment 4: ``val_threshold`` (posted price, no
    budget), ``greedy_within_budget``, ``random_within_budget``.

All return an AuctionResult with per-task winner sets, payments, and the
(possibly fractional) take-up count x_s.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.api.registry import register_auction


@dataclass
class AuctionResult:
    winners: List[List[int]]            # per task: user indices (full part.)
    payments: List[Dict[int, float]]    # per task: user -> payment
    take_up: np.ndarray                 # per task: (fractional) user count
    spent: float = 0.0
    fractional: List[Dict[int, float]] = field(default_factory=list)

    @property
    def min_take_up(self) -> float:
        return float(np.min(self.take_up))

    @property
    def diff_take_up(self) -> float:
        return float(np.max(self.take_up) - np.min(self.take_up))


def _ascending(bids_s):
    order = np.argsort(bids_s, kind="stable")
    return order, bids_s[order]


def budget_fair_auction(bids: np.ndarray, budget: float) -> AuctionResult:
    """Proportional-share mechanism per task with budget B/S each.

    Ascending bids b_1 <= b_2 <= ...; find smallest k with b_k > (B/S)/k;
    winners are the k-1 smaller bids, each paid (B/S)/(k-1).
    """
    n, S = bids.shape
    per_task = budget / S
    winners, payments, take = [], [], np.zeros(S)
    spent = 0.0
    for s in range(S):
        order, asc = _ascending(bids[:, s])
        k = 0
        while k < n and asc[k] <= per_task / (k + 1):
            k += 1
        w = list(order[:k])
        pay = per_task / k if k else 0.0
        winners.append(w)
        payments.append({int(i): pay for i in w})
        take[s] = k
        spent += pay * k
    return AuctionResult(winners, payments, take, spent)


def gmmfair(bids: np.ndarray, budget: float) -> AuctionResult:
    """Algorithm 2: greedily add the next-cheapest user to EVERY task while
    the round is affordable. Pays bids (untruthful); optimal for (14)."""
    n, S = bids.shape
    orders = [np.argsort(bids[:, s], kind="stable") for s in range(S)]
    asc = [bids[:, s][orders[s]] for s in range(S)]
    winners = [[] for _ in range(S)]
    payments = [dict() for _ in range(S)]
    B = float(budget)
    spent = 0.0
    t = 0
    while t < n:
        round_cost = sum(asc[s][t] for s in range(S))
        if round_cost > B:
            break
        for s in range(S):
            u = int(orders[s][t])
            winners[s].append(u)
            payments[s][u] = float(asc[s][t])
        B -= round_cost
        spent += round_cost
        t += 1
    take = np.array([float(len(w)) for w in winners])
    return AuctionResult(winners, payments, take, spent)


def maxmin_fair_auction(bids: np.ndarray, budget: float) -> AuctionResult:
    """Algorithm 3: MMFL Max-Min Fair auction.

    Starts budget-fair (B/S each); in round i each task admits its i-th
    cheapest user if b_{i,s} <= B_s/i (proportional-share rule; all of the
    task's winners are then paid B_s/i). When >=1 task gets stuck, slack is
    re-allocated from the ahead tasks to the stuck ones (waterfilling) if it
    covers the deficit (A < C); otherwise the remaining slack is spread as a
    terminal FRACTIONAL round over the stuck tasks and the auction ends.
    """
    n, S = bids.shape
    orders = [np.argsort(bids[:, s], kind="stable") for s in range(S)]
    asc = [bids[:, s][orders[s]] for s in range(S)]
    Bs = np.full(S, budget / S)
    winners = [[] for _ in range(S)]
    payments = [dict() for _ in range(S)]
    fractional = [dict() for _ in range(S)]
    take = np.zeros(S)
    done = np.zeros(S, bool)          # task exhausted (no more users/budget)

    for i in range(1, n + 1):
        if done.all():
            break
        idx = i - 1
        bid_i = np.array([asc[s][idx] if not done[s] else np.inf
                          for s in range(S)])
        affordable = (bid_i <= Bs / i) & ~done
        stuck = ~affordable & ~done
        if stuck.any():
            # deficit of stuck tasks to admit user i; slack of ahead tasks
            A = float(np.sum(bid_i[stuck] * i - Bs[stuck]))
            C = float(np.sum(np.maximum(Bs[affordable] - bid_i[affordable]
                                        * i, 0.0)))
            if np.isfinite(A) and A <= C and A >= 0:
                # waterfill: move A from ahead tasks' slack to stuck tasks
                slack = np.maximum(Bs - bid_i * i, 0.0) * affordable
                transfer = slack / max(slack.sum(), 1e-12) * A
                Bs = Bs - transfer                 # drain ahead tasks' slack
                Bs[stuck] = bid_i[stuck] * i       # exactly fund user i
                affordable = ~done
            else:
                # terminal fractional round: shrink the ahead tasks'
                # budgets to b_i * i (their winners are still paid >= bid),
                # freeing `rem`, which is spread over the stuck tasks.
                ahead = affordable & ~stuck
                rem = 0.0
                for s in np.where(ahead)[0]:
                    slack_s = max(Bs[s] - bid_i[s] * i, 0.0)
                    rem += slack_s
                    Bs[s] = Bs[s] - slack_s
                    u = int(orders[s][idx])
                    winners[s].append(u)
                    pay = Bs[s] / i
                    for w in winners[s]:
                        payments[s][w] = float(pay)
                    take[s] += 1
                share = rem / max(int(stuck.sum()), 1)
                for s in np.where(stuck)[0]:
                    u = int(orders[s][idx])
                    frac_pay = min(share, float(asc[s][idx]))
                    frac = 1.0 if share >= asc[s][idx] else \
                        share / float(asc[s][idx])
                    if frac > 0:
                        fractional[s][u] = frac_pay
                        take[s] += frac
                break
        for s in np.where(affordable)[0]:
            u = int(orders[s][idx])
            winners[s].append(u)
            pay = Bs[s] / i
            for w in winners[s]:
                payments[s][w] = float(pay)
            take[s] += 1
        if idx + 1 >= n:
            done[:] = True
    spent = sum(sum(p.values()) for p in payments) + \
        sum(sum(f.values()) for f in fractional)
    return AuctionResult(winners, payments, take, spent, fractional)


def val_threshold(bids: np.ndarray, threshold: float) -> AuctionResult:
    """Posted-price baseline (valThreshold): every user with cost below the
    threshold joins; no budget."""
    n, S = bids.shape
    winners, payments = [], []
    take = np.zeros(S)
    for s in range(S):
        w = [int(i) for i in range(n) if bids[i, s] < threshold]
        winners.append(w)
        payments.append({i: threshold for i in w})
        take[s] = len(w)
    return AuctionResult(winners, payments, take,
                         float(threshold * take.sum()))


def greedy_within_budget(bids: np.ndarray, budget: float) -> AuctionResult:
    """Equal budget per task; add users by ascending bid, pay bids."""
    n, S = bids.shape
    per_task = budget / S
    winners, payments = [], []
    take = np.zeros(S)
    spent = 0.0
    for s in range(S):
        order, asc = _ascending(bids[:, s])
        w, pays, left = [], {}, per_task
        for j in range(n):
            if asc[j] <= left:
                u = int(order[j])
                w.append(u)
                pays[u] = float(asc[j])
                left -= asc[j]
            else:
                break
        winners.append(w)
        payments.append(pays)
        take[s] = len(w)
        spent += per_task - left
    return AuctionResult(winners, payments, take, spent)


def random_within_budget(rng: np.random.Generator, bids: np.ndarray,
                         budget: float) -> AuctionResult:
    """Equal budget per task; add users in random order, pay bids."""
    n, S = bids.shape
    per_task = budget / S
    winners, payments = [], []
    take = np.zeros(S)
    spent = 0.0
    for s in range(S):
        order = rng.permutation(n)
        w, pays, left = [], {}, per_task
        for u in order:
            if bids[u, s] <= left:
                w.append(int(u))
                pays[int(u)] = float(bids[u, s])
                left -= bids[u, s]
        winners.append(w)
        payments.append(pays)
        take[s] = len(w)
        spent += per_task - left
    return AuctionResult(winners, payments, take, spent)


# ------------------------------------------------------------------ registry
# Scenario-API adapters: every mechanism under the uniform signature
# fn(bids, budget, *, rng=None, **options) -> AuctionResult, so an
# AuctionSpec can name any of them by key.

register_auction("maxmin_fair")(
    lambda bids, budget, *, rng=None: maxmin_fair_auction(bids, budget))
register_auction("budget_fair")(
    lambda bids, budget, *, rng=None: budget_fair_auction(bids, budget))
register_auction("gmmfair")(
    lambda bids, budget, *, rng=None: gmmfair(bids, budget))
register_auction("greedy_within_budget")(
    lambda bids, budget, *, rng=None: greedy_within_budget(bids, budget))


@register_auction("random_within_budget")
def _random_within_budget(bids, budget, *, rng=None):
    rng = rng if rng is not None else np.random.default_rng(0)
    return random_within_budget(rng, bids, budget)


@register_auction("val_threshold")
def _val_threshold(bids, budget, *, rng=None, threshold=0.4):
    del budget  # posted price: no budget constraint
    return val_threshold(bids, threshold)
