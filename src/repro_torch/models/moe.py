"""Mixture-of-Experts FFN: top-k router, shared experts, capacity dispatch.

As in the JAX package: tokens are split into ``groups`` dispatch groups;
within each group every expert picks its top-C tokens by gate weight (C =
n*k/E * capacity_factor, at least 8, at most n); tokens beyond capacity are
dropped (the residual and the shared experts still apply). Expert weights
are stacked (E, d, ff), and the expert products are batched einsums over E,
as in the JAX package, which sends them to no kernel.

Two choices keep the result deterministic and alike on the CPU and the
card. The selections are stable descending sorts, so ties (most gates of
an expert are exactly 0) go to the lower token index, as ``lax.top_k``
breaks them; which zero-gate tokens fill an expert's slots changes no
value, since their weight is 0. The combine adds one expert at a time
(``index_add_`` of that expert's C distinct tokens), so no two updates of
one call collide and each token's sum runs in expert order, as the JAX
package's scatter-add does.

The capacity depends on the token count of one call, so a caller keeps
the JAX package's calls: one per cohort row where it ``vmap``s rows. On
DTensors the routing, dispatch and combine run per group on the local
shards (``moe_ffn``), so the routing is the plain path's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import prng
from repro_torch.models.layers import dtype_of, normal
from repro_torch.sharding.partition import on_local_shards

F32 = torch.float32


def init_moe(key, cfg):
    """Router, experts and shared experts; key (..., 2) -> leaves with
    those leading axes. The router is f32 whatever the param dtype."""
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.moe_d_ff
    E = cfg.padded_experts            # dummy experts (if any) masked in moe_ffn
    ks = prng.split(key, 5)
    p = {
        "router": normal(ks[..., 0, :], (d, E), d ** -0.5, F32),
        "gate": normal(ks[..., 1, :], (E, d, f), d ** -0.5, dt),
        "up": normal(ks[..., 2, :], (E, d, f), d ** -0.5, dt),
        "down": normal(ks[..., 3, :], (E, f, d), f ** -0.5, dt),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        k3 = prng.split(ks[..., 4, :], 3)
        p["shared"] = {
            "gate": normal(k3[..., 0, :], (d, fs), d ** -0.5, dt),
            "up": normal(k3[..., 1, :], (d, fs), d ** -0.5, dt),
            "down": normal(k3[..., 2, :], (fs, d), fs ** -0.5, dt),
        }
    return p


def capacity(n_tokens_per_group: int, cfg) -> int:
    c = math.ceil(n_tokens_per_group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return min(n_tokens_per_group, max(8, c))


def _top(x, k: int):
    """The ``k`` largest along the last axis, ties to the lower index:
    ``lax.top_k``'s order, on every device."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_route(p, cfg, xf):
    """The router and the capacity dispatch of ``moe_ffn``. xf: (G, n, d).
    Returns (probs (G, n, E) f32, topi (G, n, k) the experts each token
    chose, w_sel (G, E, C) the gates of each expert's picks, idx (G, E, C)
    the tokens it picked; a pick with gate 0 is a token that did not
    choose the expert)."""
    G, n, _ = xf.shape
    E, k = cfg.padded_experts, cfg.top_k
    logits = xf.to(F32) @ p["router"].to(F32)                   # (G, n, E)
    if E > cfg.n_experts:             # mask padded (dummy) experts
        pad_mask = torch.arange(E, device=xf.device) >= cfg.n_experts
        logits = logits.masked_fill(pad_mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top(probs, k)                                 # (G, n, k)
    if cfg.norm_topk:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    gates = torch.sum(F.one_hot(topi, E).to(F32) * topv[..., None], dim=2)   # (G, n, E)
    # per-expert top-C tokens within each group
    w_sel, idx = _top(gates.transpose(1, 2), capacity(n, cfg))  # (G, E, C)
    return probs, topi, w_sel, idx


def _dispatch(xf, router, gate, up, down, *, cfg):
    """Route, dispatch, run the experts and combine, on (G, n, d) tokens.
    Returns (out (G, n, d), each group's share of first choices (G, E),
    each group's mean router probabilities (G, E))."""
    G, n, d = xf.shape
    E = cfg.padded_experts
    probs, topi, w_sel, idx = moe_route({"router": router}, cfg, xf)
    C = idx.shape[-1]
    xs = torch.gather(xf, 1, idx.reshape(G, E * C, 1).expand(G, E * C, d))
    xs = xs.reshape(G, E, C, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xs, gate)) * torch.einsum("gecd,edf->gecf", xs, up)
    ye = torch.einsum("gecf,efd->gecd", h, down)
    ye = ye * w_sel[..., None].to(ye.dtype)

    # one expert at a time: its C tokens are distinct, so no add collides
    out = torch.zeros(G * n, d, dtype=ye.dtype, device=xf.device)
    rows = idx + (torch.arange(G, device=xf.device) * n)[:, None, None]   # (G, E, C)
    for e in range(E):
        out.index_add_(0, rows[:, e].reshape(-1), ye[:, e].reshape(G * C, d))
    frac = torch.mean(F.one_hot(topi[..., 0], E).to(F32), dim=1)
    return out.reshape(G, n, d), frac, torch.mean(probs, dim=1)


def moe_ffn(p, cfg, x, groups: int = 1):
    """x: (B, S, d) -> (y, aux_loss). ``groups`` must divide B*S.

    On a DTensor x the tokens keep their batch split on the mesh dims the
    dispatch groups follow (the split's product divides ``groups``, as
    the dry-run's ``moe_groups`` of 16 follows the 'data' axis), and are
    gathered whole on the others; routing, dispatch, the experts and the
    combine run on the local groups (``on_local_shards``: DTensor has no
    rules for the stable sorts, the gathers and ``index_add_``), with the
    expert weights gathered whole, so each group's routing, ties and sums
    are the plain path's. The shared experts and the load-balance loss's
    means over the groups are DTensor ops."""
    Bsz, S, d = x.shape
    G = groups
    weights = (p["router"], p["gate"], p["up"], p["down"])
    if isinstance(x, DTensor):
        # keep the batch split on the innermost mesh dims whose product
        # divides the groups ('data' alone of ('pod', 'data') for 16 groups)
        mesh, n = x.device_mesh, 1
        keep = [Replicate()] * mesh.ndim
        for j in reversed(range(mesh.ndim)):
            if x.placements[j] == Shard(0) and G % (n * mesh.shape[j]) == 0:
                keep[j], n = Shard(0), n * mesh.shape[j]
        x = x.redistribute(mesh, keep)
    xf = x.reshape(G, Bsz * S // G, d)
    out, frac, mean_prob = on_local_shards(
        _dispatch, (xf, *weights), ((1, 2), (0, 1), (0, 1, 2), (0, 1, 2), (0, 1, 2)), cfg=cfg)
    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + (F.silu(xf @ sp["gate"]) * (xf @ sp["up"])) @ sp["down"]
    # switch-style load-balance loss
    aux = cfg.padded_experts * torch.sum(frac.mean(0) * mean_prob.mean(0))
    return out.reshape(Bsz, S, d), aux
