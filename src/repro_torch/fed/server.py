"""Server-side aggregation (paper Alg. 1 line 12), on tensors.

w_s <- sum_{k in Sel} p_{k,Sel} * w_{k,s},  p_{k,Sel} = p_k / sum_{Sel} p_k

Client weights outside Sel are zero, so aggregation is one weighted mean
over the stacked cohort, which is what the fedavg kernel computes on the
flattened cohort; these per-leaf versions are its plain form.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _weighted_sum(cohort_params, norm):
    return tree_map(lambda leaf: torch.tensordot(norm, leaf, dims=([0], [0])),
                    cohort_params)


def aggregate(cohort_params, weights):
    """cohort_params: pytree with leading K axis; weights: (K,) >= 0.
    Returns the p_k-weighted average; callers skip tasks with no selected
    clients (all-zero weights)."""
    wsum = torch.clamp(weights.sum(), min=1e-12)
    return _weighted_sum(cohort_params, weights / wsum)


def staleness_weights(weights, staleness, beta):
    """FedAST-style staleness attenuation: w_j <- w_j / (1+s_j)^beta."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    staleness = torch.as_tensor(staleness, dtype=torch.float32, device=weights.device)
    return weights * (1.0 + staleness) ** (-beta)


def aggregate_stale(cohort_params, weights, staleness, beta):
    """Buffered async aggregation: update j contributes
    w_j / (1+staleness_j)^beta, normalised by the UNDISCOUNTED weight sum,
    so a uniformly stale buffer takes a scaled-down step. With all
    staleness zero this is ``aggregate``."""
    weights = torch.as_tensor(weights, dtype=torch.float32)
    disc = staleness_weights(weights, staleness, beta)
    return _weighted_sum(cohort_params, disc / torch.clamp(weights.sum(), min=1e-12))


def selection_weights(alloc, task_id, p_k):
    """alloc: (K,) task ids; zero out clients not allocated to task_id."""
    return (alloc == task_id).to(torch.float32) * p_k
