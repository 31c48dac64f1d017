"""Lazily materialised synthetic client shards for huge populations.

The port's counterpart of the JAX package's ``pop/data.py``, numpy only
and bit-exact with it. ``make_synthetic_task`` builds a padded
``(K, n_high, dim)`` train tensor before a round runs (about 12.8 GB at
1M clients). ``LazyFedTask`` keeps the same recipe knobs but makes a
client's shard on first dispatch from its own derived stream
``default_rng([seed, k])``: construction is O(1) in K (one vectorized
draw of the dataset sizes and the shared test set), and memory is bounded
by an LRU row cache. The shards stay numpy on the host; only a cohort's
rows go to the device (``fed.trainer.fed_client_batch``).

Shard k does not depend on whether shards 0..k-1 were ever made, but the
per-client streams are a DIFFERENT data stream from the eager path's one
Generator, so lazy data is opt-in (``population_options={"lazy_data":
true}``) and parity with the eager path is claimed only without it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import numpy as np

from repro_torch.fed.data import _warp


class _ShapeProxy:
    """Duck-types the ``.shape`` of the never-materialized train tensor
    (model init reads ``task.train_x.shape[-1]`` for the input dim)."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape


class LazyFedTask:
    """FedTask-compatible synthetic task with on-demand client shards.

    Mirrors ``make_synthetic_task``'s signature so the synthetic family's
    recipe dicts apply unchanged; rows are padded to ``n_range[1]`` with a
    sample-weight mask exactly like the eager tensors, so cohort shapes
    match the eager path.
    """

    def __init__(
        self,
        seed: int,
        name: str,
        n_clients: int,
        n_range: Tuple[int, int] = (150, 250),
        input_dim: int = 16,
        n_classes: int = 10,
        separation: float = 2.0,
        noise: float = 1.0,
        warp_depth: int = 0,
        label_noise: float = 0.0,
        non_iid: bool = True,
        n_test: int = 2000,
        difficulty: str = "",
        cache_rows: int = 4096,
    ):
        self.seed = int(seed)
        self.name = name
        self.n_clients = int(n_clients)
        self.n_low, self.n_high = int(n_range[0]), int(n_range[1])
        self.input_dim = int(input_dim)
        self.n_classes = int(n_classes)
        self.separation = float(separation)
        self.noise = float(noise)
        self.warp_depth = int(warp_depth)
        self.label_noise = float(label_noise)
        self.non_iid = bool(non_iid)
        self.difficulty = difficulty or name
        self.cache_rows = int(cache_rows)

        root = np.random.default_rng(self.seed)
        self.centers = root.normal(size=(self.n_classes, self.input_dim)) * self.separation
        # one vectorized draw for every client's dataset size: O(K) memory
        # (8 bytes/client), the only per-client state built upfront
        self._sizes = root.integers(self.n_low, self.n_high + 1, size=self.n_clients)
        self.p_k = (self._sizes / self._sizes.sum()).astype(np.float32)
        # shared test set on its own derived stream ([seed, K] cannot
        # collide with any client stream [seed, k], k < K)
        self.test_x, self.test_y = self._sample(
            np.random.default_rng([self.seed, self.n_clients]),
            int(n_test),
            np.arange(self.n_classes),
        )
        self._cache: OrderedDict[int, tuple] = OrderedDict()

    @property
    def train_x(self) -> _ShapeProxy:
        return _ShapeProxy((self.n_clients, self.n_high, self.input_dim))

    def _sample(self, rng: np.random.Generator, n: int, classes: np.ndarray):
        """The eager recipe's ``sample`` body, on an explicit stream."""

        y = rng.choice(classes, size=n)
        x = self.centers[y] + rng.normal(size=(n, self.input_dim)) * self.noise
        if self.warp_depth:
            x = _warp(np.random.default_rng(self.seed + 1), x, self.warp_depth)
        if self.label_noise:
            flip = rng.random(n) < self.label_noise
            y = np.where(flip, rng.integers(0, self.n_classes, n), y)
        return x.astype(np.float32), y.astype(np.int32)

    def _row(self, k: int):
        """Client ``k``'s padded (x, y, w) row, materialized on first use."""
        hit = self._cache.get(k)
        if hit is not None:
            self._cache.move_to_end(k)
            return hit
        rng = np.random.default_rng([self.seed, k])
        classes = (
            rng.permutation(self.n_classes)[: max(1, self.n_classes // 2)]
            if self.non_iid
            else np.arange(self.n_classes)
        )
        n_k = int(self._sizes[k])
        x, y = self._sample(rng, n_k, classes)
        xr = np.zeros((self.n_high, self.input_dim), np.float32)
        yr = np.zeros(self.n_high, np.int32)
        wr = np.zeros(self.n_high, np.float32)
        xr[:n_k], yr[:n_k], wr[:n_k] = x, y, 1.0
        self._cache[k] = (xr, yr, wr)
        while len(self._cache) > self.cache_rows:
            self._cache.popitem(last=False)
        return xr, yr, wr

    def gather(self, client_ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stacked cohort data ``(x (m, n_high, dim), y, w)`` as numpy: the
        hook ``fed_client_batch`` calls in place of indexing the eager
        train tensors."""
        rows = [self._row(int(k)) for k in np.asarray(client_ids, np.int64)]
        x = np.stack([r[0] for r in rows])
        y = np.stack([r[1] for r in rows])
        w = np.stack([r[2] for r in rows])
        return x, y, w


__all__ = ["LazyFedTask"]
