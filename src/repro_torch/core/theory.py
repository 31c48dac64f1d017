"""Numeric versions of the paper's theory objects (Section IV).

The port's copy of the JAX package's ``core/theory.py``, on the port's
``core/allocation.py::alpha_fair_probs``.

These are used by tests to CHECK the paper's analytical claims on small
instances (Lemma 1 variance ordering, Corollary 5 monotonicity) and by
benchmarks to plot convergence-bound terms alongside empirical curves.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.allocation import alpha_fair_probs


def task_selection_prob(losses, alpha, s):
    """bar f_s(alpha) = f_s^alpha / sum f^alpha (binomial parameter of
    B_Sel^s, Eq. 7)."""
    f = np.asarray(losses, np.float64)
    w = f ** alpha
    return float(w[s] / w.sum())


def corollary5_term(losses, alpha, s, n_clients):
    """E[ 1/|Sel| ] under |Sel| ~ Binomial(K, bar f_s(alpha)) restricted to
    |Sel|>=1 — the sigma^2 coefficient in Thm. 4's bound (Cor. 5 shows it is
    decreasing in alpha for the worst task when p_k = 1/K)."""
    q = task_selection_prob(losses, alpha, s)
    K = n_clients
    total = 0.0
    for j in range(1, K + 1):
        total += (1.0 / j) * math.comb(K, j) * q ** j * (1 - q) ** (K - j)
    return total


def expected_allocation(losses, alpha, n_clients):
    """Expected number of clients per task under Eq. 4."""
    p = np.asarray(alpha_fair_probs(losses, alpha))
    return p * n_clients


def convergence_bound(T, gamma, tau, G2, sigma2, rho_bar, rho_tilde, L, mu,
                      Gamma_s, w0_dist):
    """Corollary 6 error bound after T rounds (all constants supplied)."""
    lead = 1.0 / (T + gamma)
    bracket = (4 * (16 * tau ** 2 * G2 + sigma2) / (3 * rho_bar * mu ** 2)
               + 8 * L ** 2 * Gamma_s / mu ** 2
               + L * gamma * w0_dist / 2)
    bias = 8 * L * Gamma_s / (3 * mu) * (rho_tilde / rho_bar - 1.0)
    return lead * bracket + bias
