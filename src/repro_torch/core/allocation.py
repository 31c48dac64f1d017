"""FedFairMMFL client-task allocation probabilities (paper Alg. 1, Eq. 4).

Each round, every active client is assigned task s with probability

    p_s = f_s^(alpha-1) / sum_s' f_s'^(alpha-1)          (Eq. 4)

where f_s is task s's prevailing global loss (1 - test accuracy in the
paper's experiments). alpha=1 is uniform (the "Random" baseline); large
alpha sends all clients to the worst task. The sync trainer samples from
these probabilities on the host with its own numpy stream
(``alpha_fair_probs``: an f32 log-space softmax in numpy).

The key-driven allocators (``allocate`` and its three strategies,
``assign_completion``) and Eq. 7's ``selection_probability`` are torch:
they draw from ``prng`` keys, run on the device of their key with no host
sync (given losses and eligibility rows on that device; an array is
copied there), and return what the JAX package's functions return bit for bit,
on the CPU and on a card: every float step is one correctly rounded torch
op or XLA:CPU's own f32 log and exp (``prng._log_f32``, ``prng._exp_f32``),
with subnormals flushed as XLA:CPU flushes them.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from repro_torch import prng
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


def _f32(v) -> float:
    return float(np.float32(v))


def _probs_on(losses, alpha, device) -> torch.Tensor:
    """Eq. 4 on ``device`` (None: a tensor's own) as the JAX package
    evaluates it on the CPU: the f32 log-space softmax of
    ``jax.nn.softmax``, its sums taken in index order."""
    f = torch.as_tensor(losses, dtype=torch.float32, device=device)
    logf = prng._log_f32(torch.clamp(f, min=_f32(1e-12))) * _f32(alpha - 1.0)
    e = prng._exp_f32(logf - logf.max())
    return e / _sum_in_order(e)


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis, taken in index order."""
    total = v[..., 0]
    for i in range(1, v.shape[-1]):
        total = total + v[..., i]
    return total


def _logits(p: torch.Tensor) -> torch.Tensor:
    return prng._log_f32(torch.clamp(p, min=_f32(1e-12)))


def allocate_fedfair(key, losses, n_clients, alpha):
    """Sample a task id per client (iid categorical per Eq. 4)."""
    p = _probs_on(losses, alpha, key.device)
    return prng.categorical(key, _logits(p), shape=(n_clients,)).to(torch.int32)


def allocate_random(key, n_tasks, n_clients):
    return prng.randint(key, (n_clients,), 0, n_tasks).to(torch.int32)


def allocate_round_robin(round_idx, n_tasks, n_clients, key=None):
    """Active clients are assigned tasks sequentially; the offset rotates
    across rounds so each task sees every client position over time. With
    a key (on whose device it runs), a permutation randomises which client
    gets which slot."""
    device = key.device if key is not None else None
    base = ((torch.arange(n_clients, device=device) + round_idx) % n_tasks).to(torch.int32)
    if key is not None:
        base = prng.permutation(key, base)
    return base


def allocate(key, strategy, losses, n_clients, alpha=3.0, round_idx=0):
    """Dispatch. losses: (S,). Returns (n_clients,) int32 task ids."""
    n_tasks = losses.shape[0]
    if strategy == AllocationStrategy.FEDFAIR:
        return allocate_fedfair(key, losses, n_clients, alpha)
    if strategy == AllocationStrategy.RANDOM:
        return allocate_random(key, n_tasks, n_clients)
    if strategy == AllocationStrategy.ROUND_ROBIN:
        return allocate_round_robin(round_idx, n_tasks, n_clients, key)
    raise ValueError(strategy)


def assign_completion(key, losses, elig_row, alpha):
    """Async MMFL: sample the next task for ONE completing client, the
    device-side counterpart of ``MMFLCoordinator.assign_next``.

    Eq. 4 on prevailing losses, renormalised over the client's eligible
    tasks (auction outcome). elig_row: (S,) bool/0-1. Returns an int32
    scalar, -1 when the client is eligible for nothing (assign_next's
    None): the auction outcome is never violated.

    As every ``prng`` draw, it broadcasts over leading key axes: keys
    (..., 2) with rows (..., S) give (...) task ids in one call, each the
    one its key gives alone (what ``jax.vmap`` of the reference gives).
    """
    dev = key.device
    p = _probs_on(losses, alpha, dev) * torch.as_tensor(elig_row, dtype=torch.float32,
                                                        device=dev)
    tot = _sum_in_order(p)[..., None]
    S = p.shape[-1]
    safe = torch.where(tot > 0, p / torch.clamp(tot, min=_f32(1e-12)),
                       torch.full_like(p, _f32(np.float32(1) / np.float32(S))))
    s = prng.categorical(key, torch.broadcast_to(_logits(safe), (*key.shape[:-1], S)))
    return torch.where(tot[..., 0] > 0, s, -1).to(torch.int32)


def _int_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for a Python int y as XLA evaluates ``lax.integer_pow``:
    repeated squaring, each product rounded (subnormals flushed)."""
    if y == 0:
        return torch.ones_like(x)
    acc, n = None, abs(y)
    while n > 0:
        if n & 1:
            acc = x if acc is None else prng._flush(acc * x)
        n >>= 1
        if n > 0:
            x = prng._flush(x * x)
    return 1.0 / acc if y < 0 else acc


def selection_probability(losses, alpha, n_selected, n_clients):
    """B_Sel^s(alpha) (Eq. 7): probability that a specific |Sel|-subset is
    allocated to task s, (S, 1) float32 on the device of ``losses`` (the
    CPU for an array). Used by the convergence-bound terms."""
    p = _probs_on(losses, alpha + 1.0, None)[:, None]  # Eq. 7 uses f^alpha
    return prng._flush(_int_pow(p, int(n_selected)) * _int_pow(1 - p, int(n_clients - n_selected)))
