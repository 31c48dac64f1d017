"""Optimizers from scratch: pytree-native AdamW and SGD.

The port's counterpart of the JAX package's ``optim/optim.py``. An
Optimizer is a pair (init, update):

    state = init(params)
    new_params, new_state = update(params, grads, state)

Moments are kept in f32 whatever the param dtype. The scalars follow the
reference's f32 arithmetic: the step count is an int32 tensor, the bias
corrections ``1 - b**count`` are f32 powers of an f32 count, and Python
float hyper-parameters meet f32 tensors, so they are rounded to f32 as
JAX's weak types are. The global norm of ``clip_by_global_norm`` adds the
per-leaf sums in ``jax.tree.leaves`` order (dict keys sorted), so it
rounds as the reference's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import tree_leaves_sorted, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` so that their global l2 norm is at most ``max_norm``.
    Returns (clipped grads, the global norm before clipping)."""
    gn = torch.sqrt(sum(g.to(F32).square().sum() for g in tree_leaves_sorted(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gn


def _as_param(g, p):
    """``g`` laid out as its param: a DTensor gradient whose placements
    differ from the param's (a stacked leaf's gradient comes back split
    along the layer axis, a replicated one as a pending sum) is
    redistributed to them, so the step and its state keep each param's
    layout."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _zeros_f32(p):
    # zeros_like: a DTensor param gets moments of its own layout
    return torch.zeros_like(p, dtype=F32, memory_format=torch.contiguous_format)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, max_grad_norm=0.0):
    def init(params):
        leaf = tree_leaves_sorted(params)[0]
        return {
            "mu": tree_map(_zeros_f32, params),
            "nu": tree_map(_zeros_f32, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
        }

    def update(params, grads, state, lr_scale=1.0):
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        count = state["count"] + 1
        c = count.to(F32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c

        def upd(p, g, mu, nu):
            g32 = _as_param(g, p).to(F32)
            mu = b1 * mu + (1 - b1) * g32
            nu = b2 * nu + (1 - b2) * g32.square()
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            step = step + weight_decay * p.to(F32)
            newp = p.to(F32) - lr * lr_scale * step
            return newp.to(p.dtype), mu, nu

        # (p, mu, nu) triples at the params' leaves, matched by key
        out = tree_map(upd, params, grads, state["mu"], state["nu"])
        newp, mu, nu = (tree_map(lambda _, o, i=i: o[i], params, out) for i in range(3))
        return newp, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


def sgd(lr=0.1, momentum=0.0):
    def init(params):
        if momentum:
            return {"vel": tree_map(_zeros_f32, params)}
        return {}

    def update(params, grads, state, lr_scale=1.0):
        if momentum:
            vel = tree_map(lambda v, g: momentum * v + g.to(F32), state["vel"], grads)
            newp = tree_map(lambda p, v: (p.to(F32) - lr * lr_scale * v).to(p.dtype),
                            params, vel)
            return newp, {"vel": vel}
        newp = tree_map(lambda p, g: (p.to(F32) - lr * lr_scale * g.to(F32)).to(p.dtype),
                        params, grads)
        return newp, state

    return Optimizer(init, update)
