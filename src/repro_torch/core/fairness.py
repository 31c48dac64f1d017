"""Fairness metrics over task performance (paper Section IV-A, Section VI).

The paper's headline metrics: minimum test accuracy across tasks, variance
of task accuracies (Lemma 1), and cosine-similarity-style uniformity
(Lemma 2). The alpha-fair objective (Eq. 2) is included for monitoring.
All of them read host-side accuracy curves, so this module is numpy.
"""

from __future__ import annotations

import numpy as np


def alpha_fair_objective(losses, alpha):
    """g^alpha = sum_s f_s^alpha (Eq. 2), in float32."""
    losses = np.asarray(losses, np.float32)
    return np.sum(np.maximum(losses, np.float32(1e-12)) ** np.float32(alpha))


def cosine_uniformity(values):
    """cos(values, 1) = mean / rms — 1.0 iff perfectly uniform (Lemma 2)."""
    v = np.asarray(values, np.float64)
    rms = np.sqrt(np.mean(v ** 2))
    return float(np.mean(v) / max(rms, 1e-12))


def fairness_report(accuracies) -> dict:
    a = np.asarray(accuracies, np.float64)
    return {
        "min_acc": float(a.min()),
        "max_acc": float(a.max()),
        "mean_acc": float(a.mean()),
        "var_acc": float(a.var()),
        "cosine_uniformity": cosine_uniformity(a),
    }


def time_to_accuracy(times, accs, target):
    """Per-task simulated time at which each task FIRST reaches ``target``
    accuracy — on the running best, so a transient dip after the hit does
    not un-reach it. ``times`` is the (T,) simulated clock, ``accs`` the
    (T, S) accuracy curve; returns a length-S list with ``None`` for
    tasks that never reach the target."""
    times = np.asarray(times, np.float64)
    accs = np.asarray(accs, np.float64)
    if accs.ndim != 2 or len(times) != len(accs):
        raise ValueError(
            f"time_to_accuracy: times {times.shape} and accs {accs.shape} "
            "must be (T,) and (T, S)")
    out = []
    for s in range(accs.shape[1]):
        best = np.maximum.accumulate(accs[:, s]) if len(accs) else accs[:, s]
        hit = np.nonzero(best >= target)[0]
        out.append(float(times[hit[0]]) if len(hit) else None)
    return out


def time_to_accuracy_report(times, accs, target, task_names=None) -> dict:
    """Per-task time-to-target plus the cross-task spread: a policy is
    unfair in TIME if one task reaches the target much later (or never).
    ``max_time``/``mean_time``/``var_time`` cover the tasks that reached
    the target; ``max_time`` is ``None`` unless ALL did."""
    per_task = time_to_accuracy(times, accs, target)
    reached = [t for t in per_task if t is not None]
    return {
        "target": float(target),
        "per_task": (per_task if task_names is None
                     else dict(zip(list(task_names), per_task))),
        "n_reached": len(reached),
        "n_unreached": len(per_task) - len(reached),
        "max_time": (float(max(reached))
                     if len(reached) == len(per_task) and reached
                     else None),
        "mean_time": float(np.mean(reached)) if reached else None,
        "var_time": float(np.var(reached)) if reached else None,
    }
