"""FedFairMMFL client-task allocation probabilities (paper Alg. 1, Eq. 4).

Each round, every active client is assigned task s with probability

    p_s = f_s^(alpha-1) / sum_s' f_s'^(alpha-1)          (Eq. 4)

where f_s is task s's prevailing global loss (1 - test accuracy in the
paper's experiments). alpha=1 is uniform (the "Random" baseline); large
alpha sends all clients to the worst task. The sync trainer samples from
these probabilities on the host with its own numpy stream, so this module
is numpy: the probabilities are an f32 log-space softmax, computed as
``jax.nn.softmax`` computes it in the JAX package.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from repro_torch.api.registry import ALLOCATORS


class AllocationStrategy(str, Enum):
    FEDFAIR = "fedfair"          # alpha-fair (Eq. 4)
    RANDOM = "random"            # uniform (== alpha=1)
    ROUND_ROBIN = "round_robin"  # Bhuyan & Moharir baseline


# an entry is either an AllocationStrategy member (the built-ins) or any
# callable (losses, alpha) -> (S,) probabilities, consumed by
# custom_or_fedfair_probs
for _s in AllocationStrategy:
    ALLOCATORS.add(_s.value, _s)


def custom_or_fedfair_probs(strategy, losses, alpha):
    """Eq. 4 for the built-in FEDFAIR enum, otherwise call the registered
    plugin and renormalise its output. RANDOM/ROUND_ROBIN are handled by
    the callers (they need no loss-dependent probabilities)."""
    if isinstance(strategy, AllocationStrategy):
        return alpha_fair_probs(losses, alpha)
    probs = np.maximum(np.asarray(strategy(losses, alpha), np.float64), 0.0)
    tot = probs.sum()
    if not np.isfinite(tot) or tot <= 0:
        raise ValueError(
            f"custom allocator returned invalid probabilities: {probs}")
    return probs / tot


def alpha_fair_probs(losses, alpha) -> np.ndarray:
    """Eq. 4. losses: (S,) positive; returns (S,) float32 probabilities,
    computed in log space for numerical stability at large alpha."""
    f32 = np.float32
    losses = np.asarray(losses, f32)
    logf = np.log(np.maximum(losses, f32(1e-12))) * f32(alpha - 1.0)
    e = np.exp(logf - logf.max())
    return e / e.sum()
