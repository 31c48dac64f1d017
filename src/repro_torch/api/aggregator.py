"""Server-side aggregation rules: ``fedavg``, the FedOpt server
optimizers, the robust rules and ``qfedavg``.

The port's counterpart of the JAX package's ``api/aggregator.py``:
``fedavg``, ``fedavgm``, ``fedadam``, ``fedyogi``, the coordinate-wise
``fedmedian`` and ``trimmed_mean`` (plain torch: a sort along the cohort
axis, as the reference's are plain ``jnp``), and ``qfedavg``, whose fold
goes through the backend (the CUDA fedavg kernel under ``vmap`` on a
card) with rescaled weights.

Contract
--------
Instances are config; per-task server state (optimizer moments) is held
by the engine and threaded through every call:

    state = agg.init(task_params)            # None for stateless rules
    update, state = agg.aggregate(stacked_deltas, weights, state,
                                  normalizer=None)

Two entry points adapt the contract to the engines' shapes:

  * ``aggregate_params`` — the sync trainer's form (cohorts of ABSOLUTE
    client params). The generic rule delta-ises, aggregates and steps;
    the ``fedavg`` override is the direct weighted mean of the absolute
    params, the operation order of the reference trace.
  * ``aggregate_stale`` — the async flush (FedAST): discount the weights
    by staleness and normalise by the UNDISCOUNTED sum. The server
    optimizers fuse discount, reduce and moment update into one
    ``kernels.fused_aggregate`` call over the flattened cohort: the CUDA
    kernel when the deltas are on the card (``fused=None`` selects it
    there), the unfused per-leaf composition on the CPU, as the JAX
    package does on its CPU backend.

``state_dict``/``load_state`` are JSON-native config records (name +
options); ``load_state`` refuses a record of another rule or options.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.backend import get_backend
from repro_torch.api.registry import AGGREGATORS, register_aggregator
from repro_torch.kernels import fused_aggregate
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _weighted_mean_f32(stacked, weights, normalizer=None):
    """f32 weighted mean over the leading cohort axis of every leaf, so
    optimizer moments never round-trip through a low-precision delta
    dtype."""
    device = tree_leaves(stacked)[0].device
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    denom = w.sum() if normalizer is None else torch.as_tensor(
        normalizer, dtype=torch.float32).to(device)
    norm = w / torch.clamp(denom, min=1e-12)
    return tree_map(
        lambda leaf: torch.tensordot(norm, leaf.to(torch.float32), dims=([0], [0])), stacked)


def _cast_like(update, stacked):
    """Cast an f32 update pytree back to the cohort leaf dtypes."""
    return tree_map(lambda u, leaf: u.to(leaf.dtype), update, stacked)


class Aggregator:
    """Server aggregation protocol; see the module docstring."""

    name = "base"
    backend = None  # ExecutionBackend; set by get_aggregator, else "serial"

    def __init__(self):
        self._options: Dict[str, Any] = {}

    def _agg_backend(self, stacked):
        """The backend that folds for this rule: the one it was given, else
        ``serial`` on the device of ``stacked``, built for each call so
        that no device sticks to the rule."""
        if self.backend is not None:
            return self.backend
        return get_backend("serial", device=tree_leaves(stacked)[0].device)

    def init(self, task_params) -> Optional[Any]:
        """Fresh per-task server state (None for stateless rules)."""
        del task_params
        return None

    def aggregate(self, stacked_deltas, weights, server_state,
                  normalizer=None) -> Tuple[Any, Any]:
        """Fold a stacked cohort of deltas into one params-shaped update.
        Returns ``(update, new_server_state)``."""
        raise NotImplementedError

    def aggregate_params(self, params, stacked_params, weights,
                         server_state, normalizer=None) -> Tuple[Any, Any]:
        """Sync-trainer entry point: cohorts carry ABSOLUTE client params.
        Generic rule: delta-ise against the current globals, aggregate in
        delta space, step. Returns ``(new_params, state)``."""
        with span("mmfl.fold"):
            deltas = tree_map(lambda c, p: c - p, stacked_params, params)
            update, server_state = self.aggregate(deltas, weights, server_state,
                                                  normalizer=normalizer)
            new_params = tree_map(lambda p, u: (p + u).to(p.dtype), params, update)
            return new_params, server_state

    def aggregate_stale(self, stacked_deltas, weights, staleness, beta,
                        server_state, normalizer=None) -> Tuple[Any, Any]:
        """Async flush entry point (FedAST): discount each update's weight
        by ``(1+staleness)^-beta`` and normalise by the UNDISCOUNTED
        weight sum (stale work nudges, never overwrites)."""
        from repro_torch.fed.server import staleness_weights

        with span("mmfl.fold"):
            w = torch.as_tensor(weights, dtype=torch.float32)
            disc = staleness_weights(w, staleness, beta)
            norm = w.sum() if normalizer is None else normalizer
            return self.aggregate(stacked_deltas, disc, server_state, normalizer=norm)

    def state_dict(self) -> Dict[str, Any]:
        """JSON-native config record ``{"name", "options"}``."""
        return {"name": self.name, "options": dict(self._options)}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Refuse a record written under another rule or options: the saved
        server state would be reinterpreted."""
        got = state.get("name", self.name)
        if got != self.name:
            raise ValueError(
                f"checkpoint was written by aggregator {got!r}; this run "
                f"uses {self.name!r} — resume with the same aggregator "
                "or start a fresh checkpoint directory")
        opts = state.get("options", {})
        if opts != self._options:
            raise ValueError(
                f"checkpoint aggregator options {opts!r} do not match "
                f"this run's {self._options!r}; resume with identical "
                "options")


@register_aggregator("fedavg")
class FedAvg(Aggregator):
    """Plain (staleness-discounted) weighted mean. Stateless; delegates the
    reduce to the execution backend (the CUDA fedavg kernel under
    ``vmap`` on a card)."""

    name = "fedavg"

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        agg = self._agg_backend(stacked_deltas).aggregate(stacked_deltas, weights,
                                                          normalizer=normalizer)
        return agg, server_state

    def aggregate_params(self, params, stacked_params, weights,
                         server_state, normalizer=None):
        # direct weighted mean of the ABSOLUTE cohort params: equal to the
        # delta form in real arithmetic, and the reference's float trace
        del params
        with span("mmfl.fold"):
            agg = self._agg_backend(stacked_params).aggregate(stacked_params, weights,
                                                              normalizer=normalizer)
            return agg, server_state


def _fused_flush(stacked_deltas, w, staleness, m_tree, v_tree, *, mode, beta, norm, lr,
                 beta1, beta2, eps):
    """One ``fused_aggregate`` call for a whole flush: flatten the cohort
    pytree to (K, N) and the moments to (N,), run the kernel, unflatten
    update and moments (views of the kernel's outputs). ``v_tree=None``
    (momentum only) passes ``m`` in v's place; that mode never reads it."""
    leaves = tree_leaves(stacked_deltas)
    K = leaves[0].shape[0]
    device = leaves[0].device
    flat = torch.cat([leaf.reshape(K, -1).to(torch.float32) for leaf in leaves], dim=1)
    m0 = torch.cat([leaf.reshape(-1) for leaf in tree_leaves(m_tree)])
    v0 = m0 if v_tree is None else torch.cat([leaf.reshape(-1) for leaf in tree_leaves(v_tree)])
    upd, m1, v1 = fused_aggregate(
        flat, torch.as_tensor(w, dtype=torch.float32).to(device),
        torch.as_tensor(staleness, dtype=torch.float32).to(device), m0, v0, mode=mode,
        beta=beta, normalizer=norm, lr=lr, beta1=beta1, beta2=beta2, eps=eps)
    sizes = [leaf[0].numel() for leaf in leaves]
    update = tree_unflatten(stacked_deltas, [
        part.reshape(leaf.shape[1:]).to(leaf.dtype)
        for part, leaf in zip(torch.split(upd, sizes), leaves)])

    def moments(flat_out, template):
        return tree_unflatten(template, [
            part.reshape(leaf.shape)
            for part, leaf in zip(torch.split(flat_out, sizes), tree_leaves(template))])

    return update, moments(m1, m_tree), None if v_tree is None else moments(v1, v_tree)


class _ServerOptAggregator(Aggregator):
    """Shared machinery for the stateful server optimizers (FedOpt, Reddi
    et al. 2021). Server state is an f32 pytree of moments mirroring the
    params; ``aggregate`` is the per-leaf reference, ``aggregate_stale``
    may take the fused one-pass kernel (``fused=None`` selects it when the
    deltas are on a CUDA device, the per-leaf composition otherwise;
    ``fused=True`` on the CPU takes the kernel's plain version)."""

    mode = ""  # kernels.fused_aggregate mode key

    def __init__(self, fused: Optional[bool] = None):
        super().__init__()
        self.fused = fused

    def _scalars(self) -> Dict[str, float]:
        """lr/beta1/beta2/eps for the fused kernel (unused slots are
        inert)."""
        raise NotImplementedError

    def _opt_update(self, server_state, d) -> Tuple[Any, Any]:
        """One f32 moment update from the aggregated delta ``d``. Returns
        ``(new_state, update)``."""
        raise NotImplementedError

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        d = _weighted_mean_f32(stacked_deltas, weights, normalizer)
        server_state, update = self._opt_update(server_state, d)
        return _cast_like(update, stacked_deltas), server_state

    def aggregate_stale(self, stacked_deltas, weights, staleness, beta,
                        server_state, normalizer=None):
        fused = self.fused
        if fused is None:
            fused = tree_leaves(stacked_deltas)[0].device.type == "cuda"
        if not fused:       # the base rule's span
            return super().aggregate_stale(stacked_deltas, weights, staleness, beta,
                                           server_state, normalizer=normalizer)
        with span("mmfl.fold"):
            w = torch.as_tensor(weights, dtype=torch.float32)
            norm = w.sum() if normalizer is None else normalizer
            upd, m1, v1 = _fused_flush(stacked_deltas, w, staleness, server_state["m"],
                                       server_state.get("v"), mode=self.mode, beta=beta,
                                       norm=norm, **self._scalars())
            new_state = {"m": m1}
            if "v" in server_state:
                new_state["v"] = v1
            return upd, new_state


@register_aggregator("fedavgm")
class FedAvgM(_ServerOptAggregator):
    """Server momentum: m <- momentum*m + d; update = lr*m (FedOpt)."""

    name = "fedavgm"
    mode = "fedavgm"

    def __init__(self, momentum: float = 0.9, lr: float = 1.0,
                 fused: Optional[bool] = None):
        super().__init__(fused=fused)
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"fedavgm: momentum must be in [0, 1), got {momentum}")
        if lr <= 0:
            raise ValueError(f"fedavgm: lr must be > 0, got {lr}")
        self.momentum = float(momentum)
        self.lr = float(lr)
        self._options = {"momentum": self.momentum, "lr": self.lr, "fused": self.fused}

    def init(self, task_params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), task_params)}

    def _scalars(self):
        return {"lr": self.lr, "beta1": self.momentum, "beta2": 0.0, "eps": 0.0}

    def _opt_update(self, server_state, d):
        m = tree_map(lambda m_, d_: self.momentum * m_ + d_, server_state["m"], d)
        upd = tree_map(lambda m_: self.lr * m_, m)
        return {"m": m}, upd


class _AdaptiveServerOpt(_ServerOptAggregator):
    """Shared Adam/Yogi machinery: first and second moments, v0 = eps^2,
    no bias correction (the FedOpt formulation)."""

    def __init__(self, lr: float = 1.0, beta1: float = 0.9,
                 beta2: float = 0.99, eps: float = 1e-3,
                 fused: Optional[bool] = None):
        super().__init__(fused=fused)
        if lr <= 0:
            raise ValueError(f"{self.name}: lr must be > 0, got {lr}")
        for nm, b in (("beta1", beta1), ("beta2", beta2)):
            if not 0.0 <= b < 1.0:
                raise ValueError(f"{self.name}: {nm} must be in [0, 1), got {b}")
        if eps <= 0:
            raise ValueError(f"{self.name}: eps must be > 0, got {eps}")
        self.lr = float(lr)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.eps = float(eps)
        self._options = {"lr": self.lr, "beta1": self.beta1, "beta2": self.beta2,
                         "eps": self.eps, "fused": self.fused}

    def init(self, task_params):
        return {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), task_params),
            "v": tree_map(lambda p: torch.full(p.shape, self.eps ** 2, dtype=torch.float32,
                                               device=p.device), task_params),
        }

    def _scalars(self):
        return {"lr": self.lr, "beta1": self.beta1, "beta2": self.beta2, "eps": self.eps}

    def _second_moment(self, v, d2):
        raise NotImplementedError

    def _opt_update(self, server_state, d):
        b1 = self.beta1
        m = tree_map(lambda m_, d_: b1 * m_ + (1.0 - b1) * d_, server_state["m"], d)
        v = tree_map(lambda v_, d_: self._second_moment(v_, d_ * d_), server_state["v"], d)
        upd = tree_map(lambda m_, v_: self.lr * m_ / (torch.sqrt(v_) + self.eps), m, v)
        return {"m": m, "v": v}, upd


@register_aggregator("fedadam")
class FedAdam(_AdaptiveServerOpt):
    """Server Adam: v <- beta2*v + (1-beta2)*d^2 (FedOpt)."""

    name = "fedadam"
    mode = "fedadam"

    def _second_moment(self, v, d2):
        return self.beta2 * v + (1.0 - self.beta2) * d2


@register_aggregator("fedyogi")
class FedYogi(_AdaptiveServerOpt):
    """Server Yogi: v <- v - (1-beta2)*d^2*sign(v - d^2)."""

    name = "fedyogi"
    mode = "fedyogi"

    def _second_moment(self, v, d2):
        return v - (1.0 - self.beta2) * d2 * torch.sign(v - d2)


@register_aggregator("fedmedian")
class FedMedian(Aggregator):
    """Coordinate-wise median over the cohort axis (byzantine-robust).
    Aggregation weights and staleness discounts are ignored. As
    ``jnp.median``: an even cohort takes the mean of its two middle
    values, in f32, and a column holding a NaN gives NaN."""

    name = "fedmedian"

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        del weights, normalizer

        def median(leaf):
            K = leaf.shape[0]
            x = torch.sort(leaf.to(torch.float32), dim=0).values
            mid = (x[(K - 1) // 2] + x[K // 2]) * 0.5
            nan = torch.isnan(x).any(dim=0)
            return torch.where(nan, torch.nan, mid).to(leaf.dtype)

        return tree_map(median, stacked_deltas), server_state


@register_aggregator("trimmed_mean")
class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean: drop the ``trim`` fraction of extreme
    values at each end of the cohort axis (``int(trim * K)`` of them) and
    average the rest, in f32. Weights are ignored; ``trim=0`` is the
    unweighted mean."""

    name = "trimmed_mean"

    def __init__(self, trim: float = 0.1):
        super().__init__()
        if not 0.0 <= trim < 0.5:
            raise ValueError(f"trimmed_mean: trim must be in [0, 0.5), got {trim}")
        self.trim = float(trim)
        self._options = {"trim": self.trim}

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        del weights, normalizer

        def trimmed(leaf):
            K = leaf.shape[0]
            k = int(self.trim * K)
            x = torch.sort(leaf.to(torch.float32), dim=0).values
            return x[k:K - k].mean(dim=0).to(leaf.dtype)

        return tree_map(trimmed, stacked_deltas), server_state


@register_aggregator("qfedavg")
class QFedAvg(Aggregator):
    """q-FedAvg-style fold (Li et al. 2020): each client's weight is
    scaled by ``(|delta| / mean|delta|)^q`` (l2 norms, in f64), cast to
    f32 and folded by the backend. ``q=0`` hands the weights to the
    backend unchanged, so it is fedavg bit for bit. With a normaliser (the
    async flush) the normaliser is rescaled by ``ws.sum() / w.sum()``, so
    the staleness damping ratio is kept."""

    name = "qfedavg"

    def __init__(self, q: float = 1.0):
        super().__init__()
        if q < 0:
            raise ValueError(f"qfedavg: q must be >= 0, got {q}")
        self.q = float(q)
        self._options = {"q": self.q}

    def aggregate(self, stacked_deltas, weights, server_state, normalizer=None):
        backend = self._agg_backend(stacked_deltas)
        if self.q == 0.0:
            return backend.aggregate(stacked_deltas, weights, normalizer=normalizer), server_state
        from repro_torch.api.policy import stacked_delta_norms

        norms = stacked_delta_norms(stacked_deltas)
        scale = (np.maximum(norms, 1e-12) / max(float(norms.mean()), 1e-12)) ** self.q
        w = torch.as_tensor(weights).detach().cpu().numpy().astype(np.float64)
        ws = w * scale
        norm = None
        if normalizer is not None:
            norm = float(normalizer) * float(ws.sum()) / max(float(w.sum()), 1e-12)
        agg = backend.aggregate(stacked_deltas, torch.from_numpy(ws.astype(np.float32)),
                                normalizer=norm)
        return agg, server_state


def get_aggregator(name: str, options: Optional[Dict[str, Any]] = None,
                   backend=None) -> Aggregator:
    """Resolve + construct an aggregator from its registry key; ``backend``
    is the ExecutionBackend the instance delegates weighted reduces to
    (``serial`` on the inputs' device when None)."""
    cls = AGGREGATORS.get(name)
    try:
        agg = cls(**(options or {}))
    except TypeError as e:
        raise ValueError(
            f"aggregator {name!r} rejected options {options!r}: {e}"
        ) from None
    agg.backend = backend
    return agg


def aggregator_from_config(name: Optional[str],
                           options: Optional[Dict[str, Any]],
                           backend=None) -> Aggregator:
    """Engine-side construction: ``None`` selects ``fedavg``; options
    without a name are rejected."""
    if name is None and options:
        raise ValueError(
            "aggregator_options were given without an aggregator; name "
            "one (e.g. 'fedadam') or drop the options")
    return get_aggregator(name or "fedavg", options or {}, backend=backend)


__all__ = [
    "AGGREGATORS",
    "Aggregator",
    "FedAdam",
    "FedAvg",
    "FedAvgM",
    "FedMedian",
    "FedYogi",
    "QFedAvg",
    "TrimmedMean",
    "aggregator_from_config",
    "get_aggregator",
    "register_aggregator",
]
