"""Synthetic federated datasets with CONTROLLED difficulty.

No MNIST/CIFAR offline in this container, so the paper's task mix is
emulated with class-conditional Gaussian tasks whose difficulty is set by
(class separation, input dim, label noise, nonlinear warp depth) — the
experiments validate the paper's *relations* (min-accuracy ordering,
variance reduction), not absolute accuracies (see DESIGN.md).

Non-iid partition follows the paper: each client draws data from a randomly
chosen HALF of the classes. Client dataset sizes are uniform in
[n_low, n_high] and realised by padding to n_high with a sample-weight mask
(so clients stack into rectangular arrays for vmap).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class FedTask:
    name: str
    train_x: np.ndarray      # (K, n_max, dim) float32
    train_y: np.ndarray      # (K, n_max) int32
    train_w: np.ndarray      # (K, n_max) float32 sample mask
    test_x: np.ndarray       # (n_test, dim)
    test_y: np.ndarray       # (n_test,)
    n_classes: int
    difficulty: str = ""

    @property
    def n_clients(self) -> int:
        return self.train_x.shape[0]

    @property
    def p_k(self) -> np.ndarray:
        """Per-client data fraction (aggregation weights p_{k,s})."""
        sizes = self.train_w.sum(axis=1)
        return (sizes / sizes.sum()).astype(np.float32)


def _warp(rng, x, depth):
    """Fixed random nonlinear warp — makes the class structure non-linearly
    separable (the 'needs a deeper model / more rounds' difficulty axis)."""
    for _ in range(depth):
        W = rng.normal(size=(x.shape[1], x.shape[1])) / np.sqrt(x.shape[1])
        x = np.tanh(x @ W) * 3.0
    return x


def make_synthetic_task(seed: int, name: str, n_clients: int,
                        n_range: Tuple[int, int] = (150, 250),
                        input_dim: int = 16, n_classes: int = 10,
                        separation: float = 2.0, noise: float = 1.0,
                        warp_depth: int = 0, label_noise: float = 0.0,
                        non_iid: bool = True, n_test: int = 2000,
                        difficulty: str = "") -> FedTask:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, input_dim)) * separation

    def sample(n, classes):
        y = rng.choice(classes, size=n)
        x = centers[y] + rng.normal(size=(n, input_dim)) * noise
        if warp_depth:
            x = _warp(np.random.default_rng(seed + 1), x, warp_depth)
        if label_noise:
            flip = rng.random(n) < label_noise
            y = np.where(flip, rng.integers(0, n_classes, n), y)
        return x.astype(np.float32), y.astype(np.int32)

    n_low, n_high = n_range
    xs = np.zeros((n_clients, n_high, input_dim), np.float32)
    ys = np.zeros((n_clients, n_high), np.int32)
    ws = np.zeros((n_clients, n_high), np.float32)
    all_classes = np.arange(n_classes)
    for k in range(n_clients):
        classes = (rng.permutation(n_classes)[:max(1, n_classes // 2)]
                   if non_iid else all_classes)
        n_k = int(rng.integers(n_low, n_high + 1))
        x, y = sample(n_k, classes)
        xs[k, :n_k] = x
        ys[k, :n_k] = y
        ws[k, :n_k] = 1.0
    tx, ty = sample(n_test, all_classes)
    return FedTask(name, xs, ys, ws, tx, ty, n_classes,
                   difficulty or name)


# Task mix mirroring the paper's difficulty spread. "synth-fmnist" is tuned
# to be the persistently-worst task (as Fashion-MNIST is in the paper's
# Experiment 1), "synth-mnist" the easy one, "synth-cifar" needs a bigger
# model / more rounds (nonlinear warp).
_RECIPES = {
    "synth-mnist": dict(input_dim=16, separation=3.0, noise=1.0,
                        warp_depth=0, label_noise=0.0),
    "synth-fmnist": dict(input_dim=48, separation=1.0, noise=0.9,
                         warp_depth=3, label_noise=0.0),
    "synth-cifar": dict(input_dim=32, separation=1.6, noise=1.2,
                        warp_depth=1, label_noise=0.0),
    "synth-emnist": dict(input_dim=20, separation=1.6, noise=1.1,
                         warp_depth=0, label_noise=0.02, n_classes=20),
}


def task_seed(seed: int, task_idx: int) -> int:
    """Per-task data seed derivation shared by ``standard_tasks`` and the
    scenario API's synthetic task family — ONE formula, so specs and the
    legacy helpers always build bit-identical tasks."""
    return seed * 1000 + task_idx * 17 + 3


def standard_tasks(names, n_clients, seed=0, n_range=(150, 250),
                   non_iid=True):
    tasks = []
    for i, name in enumerate(names):
        base = name.split("#")[0]            # allow duplicates: "synth-cifar#2"
        kw = dict(_RECIPES[base])
        tasks.append(make_synthetic_task(
            task_seed(seed, i), name, n_clients, n_range=n_range,
            non_iid=non_iid, **kw))
    return tasks
