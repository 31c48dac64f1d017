"""Zamba2-style hybrid: Mamba2 backbone + ONE shared attention block applied
every ``attn_every`` layers, with per-invocation LoRA adapters on the shared
q/k/v projections (Zamba2's weight-sharing signature).

Structure, as in the JAX package: the layer stack goes in GROUPS of
``attn_every`` Mamba2 layers, each followed by one shared-attention
invocation with its own LoRA slot and its own KV cache; leftover layers
(n_layers % attn_every) form a tail. Params keep the JAX package's tree
(Mamba2 layers stacked on axis 0, LoRA adapters stacked by slot), so
``interop.lm_params_from_numpy`` carries a JAX tree across by key. Where
the JAX package ``lax.scan``s over groups and layers, the port loops in
Python. Prefill returns the caches stacked (``mamba`` by layer, ``shared``
by slot); decode writes them in place.

Simplification vs the released model (the JAX package's): the shared block
consumes the current hidden state (no [x, x_emb] concat) and is a standard
pre-norm attn+MLP.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (cross_entropy, dtype_of, embed, init_embedding,
                                       init_swiglu, normal, rms_norm, stacked_init, swiglu)
from repro_torch.sharding.partition import constrain, gather_seq
from repro_torch.tree import tree_map, unstack


def n_shared_slots(cfg):
    return cfg.n_layers // cfg.attn_every


def init_hybrid(key, cfg, device=None):
    """The JAX package's ``init_hybrid(key, cfg)``: the same model from the
    same key, drawn on ``device`` (``None`` means CUDA)."""
    key = key.to(resolve_device(device))
    dt = dtype_of(cfg)
    ks = prng.split(key, 6)

    def ones():
        return torch.ones(cfg.d_model, dtype=dt, device=key.device)

    params = {
        "emb": init_embedding(ks[0], cfg.padded_vocab, cfg.d_model, dt),
        "layers": stacked_init(
            lambda k: {"ln": torch.ones(*k.shape[:-1], cfg.d_model, dtype=dt, device=k.device),
                       "mamba": ssm.init_mamba2(k, cfg)},
            ks[1], cfg.n_layers),
        "shared": {
            "ln1": ones(),
            "attn": attn.init_attention(ks[2], cfg),
            "ln2": ones(),
            "mlp": init_swiglu(ks[3], cfg.d_model, cfg.d_ff, dt),
        },
        "final_norm": ones(),
        "head": normal(ks[4], (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dt),
    }
    if cfg.shared_attn_lora_rank:
        params["lora"] = attn.init_attention_lora(ks[5], cfg, n_shared_slots(cfg),
                                                  cfg.shared_attn_lora_rank)
    return params


def _lora_slot(params, slot):
    if "lora" not in params:
        return None
    return tree_map(lambda t: t[slot], params["lora"])


def _mamba_layer(p_l, cfg, x, mode, cache=None):
    x = gather_seq(x)
    h = rms_norm(x, p_l["ln"], cfg.norm_eps)
    if mode == "decode":
        m, new_c = ssm.mamba2_decode(p_l["mamba"], cfg, h, cache)
    elif mode == "prefill":
        m, new_c = ssm.mamba2_forward(p_l["mamba"], cfg, h, return_state=True)
    else:
        m, new_c = ssm.mamba2_forward(p_l["mamba"], cfg, h), None
    return constrain(x + m, "activation"), new_c


def _shared_apply(params, cfg, x, positions, slot, mode, cache=None, pos=None):
    sp = params["shared"]
    lora = _lora_slot(params, slot)
    x = gather_seq(x)
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    new_cache = None
    if mode == "train":
        a = attn.attn_train(sp["attn"], cfg, h, positions, lora=lora)
    elif mode == "prefill":
        a, new_cache = attn.attn_prefill(sp["attn"], cfg, h, positions, lora=lora)
    else:
        a, new_cache = attn.attn_decode(sp["attn"], cfg, h, pos, cache, lora=lora)
    x = x + a
    x = x + swiglu(sp["mlp"], rms_norm(x, sp["ln2"], cfg.norm_eps))
    return constrain(x, "activation"), new_cache


def _split_layers(cfg):
    """The layer indices of each group (one per shared slot), then those
    of the tail."""
    every = cfg.attn_every
    groups = [range(s * every, (s + 1) * every) for s in range(n_shared_slots(cfg))]
    return groups, range(n_shared_slots(cfg) * every, cfg.n_layers)


def _backbone(params, cfg, x, positions, mode, caches=None, pos=None):
    """Runs the groups, the tail and the final norm. Returns (x, caches):
    the prefill caches ``{"mamba": stacked by layer, "shared": stacked by
    slot}``, or ``caches`` written in place by decode, or None in train
    mode. With ``cfg.remat`` each Mamba2 layer of a training forward runs
    under ``torch.utils.checkpoint``, as the JAX package checkpoints its
    layer scan's body."""
    layers = unstack(params["layers"])
    mamba_caches, shared_caches = [], []
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()

    def mamba(i, x):
        p_l = layers[i]
        c_l = tree_map(lambda t: t[i], caches["mamba"]) if mode == "decode" else None
        if remat:
            x, c = checkpoint(_mamba_layer, p_l, cfg, x, mode, use_reentrant=False)
        else:
            x, c = _mamba_layer(p_l, cfg, x, mode, c_l)
        mamba_caches.append(c)
        return x

    groups, tail = _split_layers(cfg)
    for slot, group in enumerate(groups):
        for i in group:
            x = mamba(i, x)
        s_cache = tree_map(lambda t: t[slot], caches["shared"]) if mode == "decode" else None
        x, c = _shared_apply(params, cfg, x, positions, slot, mode, cache=s_cache, pos=pos)
        shared_caches.append(c)
    for i in tail:
        x = mamba(i, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        caches = {name: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                  for name, cs in (("mamba", mamba_caches), ("shared", shared_caches))}
    elif mode == "train":
        caches = None
    return x, caches


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def hybrid_loss(params, cfg, batch):
    """Mean next-token CE over labels >= 0 (weighted by
    ``batch["client_weights"]`` per row where given). Returns (loss, {})."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["emb"], tokens)
    x, _ = _backbone(params, cfg, x, _positions(B, S, x.device), "train")
    logits = constrain(x @ params["head"], "logits")
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    if "client_weights" in batch:
        mask = mask * batch["client_weights"][:, None]
    return cross_entropy(logits, torch.clamp(labels, min=0), mask), {}


def hybrid_prefill(params, cfg, batch):
    """Logits of the last prompt position (B, 1, V) and the filled caches."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["emb"], tokens)
    x, caches = _backbone(params, cfg, x, _positions(B, S, x.device), "prefill")
    return constrain(x[:, -1:, :] @ params["head"], "logits"), caches


def init_hybrid_cache(params, cfg, batch_size, length, dtype):
    """Empty caches: Mamba2 state and conv per layer (their size does not
    depend on ``length``), a KV cache per shared slot."""
    device = params["final_norm"].device
    mamba_one = ssm.init_mamba2_cache(cfg, batch_size, dtype, device)
    kv_len = min(length, cfg.sliding_window) if cfg.sliding_window else length
    one = attn.init_cache(cfg, batch_size, kv_len, dtype, device)
    n_slots = n_shared_slots(cfg)
    return {"mamba": {k: t.expand(cfg.n_layers, *t.shape).clone() for k, t in mamba_one.items()},
            "shared": {k: t.expand(n_slots, *t.shape).clone() for k, t in one.items()}}


def hybrid_decode(params, cfg, token, pos, caches):
    """token: (B, 1) ints; pos: the absolute position (int). Writes the new
    state into ``caches`` in place and returns (logits (B, 1, V), caches)."""
    x = embed(params["emb"], token)
    x, caches = _backbone(params, cfg, x, None, "decode", caches=caches, pos=pos)
    return constrain(x @ params["head"], "logits"), caches
