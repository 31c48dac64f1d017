"""Cohort-execution backends: HOW a cohort of client updates runs.

The port's counterpart of the JAX package's ``api/backend.py``. Every
round reduces to two steps: run a cohort of client-local updates from
one set of global params, then fold the stacked updates with per-client
weights.

Contract
--------
``run_cohort(task_state, client_batch, rng) -> CohortResult`` runs
``task_state.local_fn`` and returns the updates stacked along a leading
client axis. In the port ``local_fn(params, keys, *data) -> (updates,
losses)`` takes a whole cohort (keys (K, 2), data with a leading K axis),
the written-out form of the JAX package's ``jax.vmap`` over a one-client
rule. It must derive all randomness from its keys (the engines key by
``fold_in(round_key, client_id)``), so every backend computes the same
per-client result:

- ``serial``  — reference: one call per client, in cohort order.
- ``vmap``    — the whole cohort in one call.
- ``sharded`` — the cohort split over a ``launch/mesh.py`` cohort mesh of
  devices (pure data parallelism over clients), one call per part, the
  parts gathered to the primary device; ``vmap`` on a one-device mesh.

``aggregate(stacked_updates, weights, normalizer=None)`` computes
``sum_k (w_k / max(normalizer, 1e-12)) * update_k`` per leaf
(``normalizer`` defaults to ``weights.sum()``). ``vmap`` flattens the
cohort to (K, N) and folds it with ``kernels.fedavg``: the CUDA kernel on
a CUDA tensor, its plain version on a CPU tensor. ``serial`` folds leaf
by leaf in plain PyTorch and never calls the kernel. The JAX package pads
cohorts to a power of two to bound XLA compilations; eager PyTorch has
nothing to compile, so the port runs cohorts at their own size.

Backends take ``device=None`` (CUDA, see ``repro_torch.device``) and move
each cohort's inputs there.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.api.registry import BACKENDS, register_backend
from repro_torch.device import resolve_device
from repro_torch.kernels import fedavg
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class CohortTask:
    """What a cohort trains: global params + the cohort update rule
    ``local_fn(params, keys, *client_data) -> (updates, losses)``."""

    name: str
    params: Any
    local_fn: Callable


@dataclass
class ClientBatch:
    """One cohort's stacked per-client inputs (leading axis = cohort
    size): ``keys`` (K, 2) PRNG keys and ``data`` tensors."""

    client_ids: np.ndarray
    keys: Any
    data: Tuple[Any, ...] = ()

    def __post_init__(self):
        self.client_ids = np.asarray(self.client_ids, np.int64)

    def __len__(self) -> int:
        return len(self.client_ids)


@dataclass
class CohortResult:
    """Stacked cohort output: ``updates`` mirrors ``local_fn``'s update
    pytree with a leading cohort axis; ``losses`` is (K,)."""

    updates: Any
    losses: Any = None


@runtime_checkable
class ExecutionBackend(Protocol):
    """What every execution backend looks like to an engine."""

    def run_cohort(self, task_state, client_batch, rng=None) -> CohortResult: ...

    def aggregate(self, stacked_updates, weights, normalizer=None): ...


def get_backend(backend, device=None) -> ExecutionBackend:
    """Resolve a backend from a registry key, class, or instance."""
    if isinstance(backend, str):
        backend = BACKENDS.get(backend)
    if isinstance(backend, type):
        backend = backend(device=device)
    return backend


def _norm_weights(weights, normalizer, device):
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    denom = w.sum() if normalizer is None else torch.as_tensor(
        normalizer, dtype=torch.float32).to(device)
    return w / torch.clamp(denom, min=1e-12)


class _Backend:
    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _data(self, client_batch):
        return tuple(tree_map(lambda t: t.to(self.device), d) for d in client_batch.data)


@register_backend("serial")
class SerialBackend(_Backend):
    """Reference backend: one call per client, in cohort order, and a
    per-leaf plain fold. Every other backend must reproduce it (<=1e-6)."""

    name = "serial"

    def run_cohort(self, task_state, client_batch, rng=None):
        with span("mmfl.cohort"):
            data = self._data(client_batch)
            updates, losses = [], []
            for i in range(len(client_batch)):
                keys_i = None if client_batch.keys is None else client_batch.keys[i:i + 1]
                data_i = tuple(tree_map(lambda leaf: leaf[i:i + 1], d) for d in data)
                upd, loss = task_state.local_fn(task_state.params, keys_i, *data_i)
                updates.append(upd)
                losses.append(loss)
            stacked = tree_map(lambda *ls: torch.cat(ls), *updates)
            return CohortResult(stacked, torch.cat(losses))

    def aggregate(self, stacked_updates, weights, normalizer=None):
        norm = _norm_weights(weights, normalizer, self.device)

        def avg(leaf):
            common = torch.promote_types(norm.dtype, leaf.dtype)
            return torch.tensordot(norm.to(common), leaf.to(common),
                                   dims=([0], [0])).to(leaf.dtype)

        return tree_map(avg, stacked_updates)


@register_backend("vmap")
class VmapBackend(_Backend):
    """The cohort as ONE ``local_fn`` call over stacked per-client data,
    and the fold as one ``kernels.fedavg`` call over the flattened
    cohort."""

    name = "vmap"

    def run_cohort(self, task_state, client_batch, rng=None):
        with span("mmfl.cohort"):
            updates, losses = task_state.local_fn(task_state.params, client_batch.keys,
                                                  *self._data(client_batch))
            return CohortResult(updates, losses)

    def aggregate(self, stacked_updates, weights, normalizer=None):
        norm = _norm_weights(weights, normalizer, self.device)
        leaves = tree_leaves(stacked_updates)
        K = leaves[0].shape[0]
        # one (K, N) copy of the cohort: the kernel reads a flat buffer
        flat = torch.cat([leaf.reshape(K, -1) for leaf in leaves], dim=1)
        agg = fedavg(flat, norm)
        parts = torch.split(agg, [leaf[0].numel() for leaf in leaves])
        return tree_unflatten(stacked_updates, [
            part.reshape(leaf.shape[1:]).to(leaf.dtype) for part, leaf in zip(parts, leaves)])


@register_backend("sharded")
class ShardedBackend(VmapBackend):
    """The vmap step with the cohort axis split across a device mesh
    (``launch/mesh.py``): pure data parallelism over clients. ``mesh`` is
    a tuple of devices (repeats allowed: a device named twice runs two
    parts); by default every card of this process (``(cpu,)`` on the CPU).
    With one device in the mesh, or fewer than two clients, it is ``vmap``.

    Otherwise the cohort's data splits into ``len(mesh)`` contiguous parts
    (``torch.tensor_split``; empty parts are skipped), each moved straight
    to its device with a copy of the params made once per device and call;
    every part's ``local_fn`` is queued before any result is read, and the
    updates and losses are gathered to the primary device in cohort order.
    The keys stay where the engine put them, as under ``vmap``. Unlike the
    JAX package, the cohort is not padded: the port runs cohorts at their
    own size, and padding changes no kept result. The fold is ``vmap``'s:
    the ``fedavg`` kernel on the primary device.
    """

    name = "sharded"

    def __init__(self, device=None, mesh=None):
        super().__init__(device)
        self._mesh = None if mesh is None else tuple(torch.device(d) for d in mesh)

    def _cohort_mesh(self):
        if self._mesh is None:
            from repro_torch.launch.mesh import make_cohort_mesh

            self._mesh = make_cohort_mesh(device=self.device)
        return self._mesh

    def run_cohort(self, task_state, client_batch, rng=None):
        mesh = self._cohort_mesh()
        if len(mesh) <= 1 or len(client_batch) < 2:
            return super().run_cohort(task_state, client_batch, rng)    # vmap's span
        with span("mmfl.cohort"):
            params_on = {}
            parts = []
            for dev, rows in zip(mesh, torch.tensor_split(torch.arange(len(client_batch)),
                                                          len(mesh))):
                if len(rows) == 0:
                    continue
                lo, hi = int(rows[0]), int(rows[-1]) + 1
                if dev not in params_on:
                    params_on[dev] = tree_map(lambda t: t.to(dev), task_state.params)
                keys = None if client_batch.keys is None else client_batch.keys[lo:hi]
                data = tuple(tree_map(lambda t: t[lo:hi].to(dev), d) for d in client_batch.data)
                on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext())
                with on_dev:
                    parts.append(task_state.local_fn(params_on[dev], keys, *data))
            updates = tree_map(lambda *ls: torch.cat([leaf.to(self.device) for leaf in ls]),
                               *(u for u, _ in parts))
            losses = torch.cat([loss.to(self.device) for _, loss in parts])
            return CohortResult(updates, losses)


__all__ = [
    "BACKENDS",
    "ClientBatch",
    "CohortResult",
    "CohortTask",
    "ExecutionBackend",
    "SerialBackend",
    "ShardedBackend",
    "VmapBackend",
    "get_backend",
    "register_backend",
]
