"""Unified model API: the dense LM and the zamba2 hybrid expose the JAX
package's five functions.

    init_params(key, cfg, device=None)          -> params
    loss_fn(params, cfg, batch)                 -> (loss, metrics)
    prefill_fn(params, cfg, batch)              -> (logits, caches)
    init_cache_fn(params, cfg, B, length, dt)   -> caches
    decode_fn(params, cfg, token, pos, caches)  -> (logits, caches)

batch is a dict: tokens/labels (+ client_weights for MMFL p_k
aggregation). ``decode_fn`` writes into the caches it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import hybrid, transformer
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    loss_fn: Callable
    prefill_fn: Callable
    init_cache_fn: Callable
    decode_fn: Callable


_APIS = {
    "dense": ModelApi(transformer.init_lm, transformer.lm_loss, transformer.lm_prefill,
                      transformer.init_lm_cache, transformer.lm_decode),
    "hybrid": ModelApi(hybrid.init_hybrid, hybrid.hybrid_loss, hybrid.hybrid_prefill,
                       hybrid.init_hybrid_cache, hybrid.hybrid_decode),
}


def get_api(cfg) -> ModelApi:
    """The API of ``cfg``'s arch type; ``dense`` and ``hybrid`` are ported."""
    transformer.check_ported(cfg)
    return _APIS[cfg.arch_type]


def pad_cache(caches, old_len: int, new_len: int):
    """Grow a prefill cache to a larger serving length (zeros / -1 pos):
    the attention leaves ``k``, ``v`` and ``positions`` grow along the
    sequence; every other leaf (the hybrid's Mamba2 ``state`` and ``conv``)
    is left as it is."""
    def grow(t, axis, fill):
        extra = list(t.shape)
        extra[axis] = new_len - old_len
        return torch.cat([t, t.new_full(extra, fill)], dim=axis)

    def pad(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = pad(leaf)
            elif name in ("k", "v") and leaf.ndim >= 3 and leaf.shape[2] == old_len:
                out[name] = grow(leaf, 2, 0)
            elif name == "positions" and leaf.shape[-1] == old_len:
                out[name] = grow(leaf, leaf.ndim - 1, -1)
            else:
                out[name] = leaf
        return out

    return pad(caches)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
