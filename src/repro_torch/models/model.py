"""Unified model API: the dense, MoE, MLA and vlm LMs, the zamba2 hybrid,
the xLSTM LM and the whisper encoder-decoder expose the JAX package's five
functions.

    init_params(key, cfg, device=None)          -> params
    loss_fn(params, cfg, batch)                 -> (loss, metrics)
    prefill_fn(params, cfg, batch)              -> (logits, caches)
    init_cache_fn(params, cfg, B, length, dt)   -> caches
    decode_fn(params, cfg, token, pos, caches)  -> (logits, caches)

batch is a dict: tokens/labels (+ frames for audio, img_embeds for vlm,
client_weights for MMFL p_k aggregation). ``decode_fn`` writes into the
caches it is given; ``init_cache_fn(..., per_row=True)`` gives a dense or
vlm LM caches whose rows decode at their own positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models import encdec, hybrid, transformer, xlstm_lm
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class ModelApi:
    init_params: Callable
    loss_fn: Callable
    prefill_fn: Callable
    init_cache_fn: Callable
    decode_fn: Callable


_LM_API = ModelApi(transformer.init_lm, transformer.lm_loss, transformer.lm_prefill,
                   transformer.init_lm_cache, transformer.lm_decode)
_APIS = {
    "dense": _LM_API,
    "moe": _LM_API,
    "vlm": _LM_API,
    "hybrid": ModelApi(hybrid.init_hybrid, hybrid.hybrid_loss, hybrid.hybrid_prefill,
                       hybrid.init_hybrid_cache, hybrid.hybrid_decode),
    "ssm": ModelApi(xlstm_lm.init_xlstm_lm, xlstm_lm.xlstm_loss, xlstm_lm.xlstm_prefill,
                    xlstm_lm.init_xlstm_cache, xlstm_lm.xlstm_decode),
    "audio": ModelApi(encdec.init_encdec, encdec.encdec_loss, encdec.encdec_prefill,
                      encdec.init_encdec_cache, encdec.encdec_decode),
}


def get_api(cfg) -> ModelApi:
    """The API of ``cfg``'s arch type (every arch type of the JAX package)."""
    transformer.check_ported(cfg)
    return _APIS[cfg.arch_type]


def pad_cache(caches, old_len: int, new_len: int):
    """Grow a prefill cache to a larger serving length (zeros / -1 pos),
    by the JAX package's rule: a leaf named ``k``, ``v``, ``c_kv`` or
    ``k_rope`` whose axis 2 is ``old_len`` grows along it, and so do
    ``positions`` along their last axis; every other leaf (the Mamba2 and
    mLSTM ``state`` and ``conv``, the sLSTM state) and a ``None`` sLSTM
    cache are left as they are. As there, whisper's cross K/V grow too
    when the encoder's frame count equals the prompt length."""
    def grow(t, axis, fill):
        extra = list(t.shape)
        extra[axis] = new_len - old_len
        return torch.cat([t, t.new_full(extra, fill)], dim=axis)

    def pad(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = pad(leaf)
            elif name in ("k", "v", "c_kv", "k_rope") and leaf.ndim >= 3 and leaf.shape[2] == old_len:
                out[name] = grow(leaf, 2, 0)
            elif name == "positions" and leaf.shape[-1] == old_len:
                out[name] = grow(leaf, leaf.ndim - 1, -1)
            else:
                out[name] = leaf
        return out

    return pad(caches)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _leaves_with_names(tree, name=""):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves_with_names(v, k)]
    return [(name, tree)]


def active_param_count(params, cfg) -> int:
    """MoE: params actually touched per token (top_k of the routed experts,
    and every other param), counted as the JAX package counts them: a leaf
    named gate, up or down whose third axis from the end is n_experts."""
    total = param_count(params)
    if not cfg.is_moe:
        return total
    expert_total = sum(leaf.numel() for name, leaf in _leaves_with_names(params)
                       if leaf.ndim >= 3 and leaf.shape[-3] == cfg.n_experts
                       and name in ("gate", "up", "down"))
    return int(total - expert_total + expert_total * cfg.top_k / cfg.n_experts)
