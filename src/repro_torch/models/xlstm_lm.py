"""xLSTM language model: groups of (slstm_every - 1) mLSTM blocks followed
by one sLSTM block (the xLSTM [7:1] interleave), then a tail of mLSTM
blocks, as the JAX package assembles it.

Params keep the JAX package's tree (``mlstm_layers`` stacked on axis 0,
the grouped layers first, then the tail; ``slstm_layers`` stacked by
group), so ``interop.lm_params_from_numpy`` carries a JAX tree across by
key. Where the JAX package ``lax.scan``s over groups and layers, the port
loops in Python. Prefill returns the caches stacked (``mlstm`` by layer,
``slstm`` by group, or None without groups); decode writes them in place.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models.layers import (cross_entropy, dtype_of, embed, init_embedding, normal,
                                       rms_norm, stacked_init)
from repro_torch.models.xlstm import (init_mlstm, init_mlstm_cache, init_slstm,
                                      init_slstm_state, mlstm_decode, mlstm_forward,
                                      slstm_decode, slstm_forward)
from repro_torch.sharding.partition import constrain, gather_seq
from repro_torch.tree import tree_map, unstack


def _layout(cfg):
    """(every, n_groups, mLSTM layers per group, tail mLSTM layers)."""
    every = cfg.slstm_every or (cfg.n_layers + 1)
    n_groups = cfg.n_layers // every
    return every, n_groups, every - 1, cfg.n_layers - n_groups * every


def init_xlstm_lm(key, cfg, device=None):
    """The JAX package's ``init_xlstm_lm(key, cfg)``: the same model from
    the same key, drawn on ``device`` (``None`` means CUDA). Of the five
    keys split, the fifth is unused, as there."""
    key = key.to(resolve_device(device))
    dt = dtype_of(cfg)
    every, n_groups, n_mpg, n_tail = _layout(cfg)
    ks = prng.split(key, 5)

    def block(init_cell):
        return lambda k: {"ln": torch.ones(*k.shape[:-1], cfg.d_model, dtype=dt, device=k.device),
                          "cell": init_cell(k, cfg)}

    params = {
        "emb": init_embedding(ks[0], cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=key.device),
        "head": normal(ks[3], (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dt),
    }
    n_mlstm = n_groups * n_mpg + n_tail
    if n_mlstm:
        params["mlstm_layers"] = stacked_init(block(init_mlstm), ks[1], n_mlstm)
    if n_groups:
        params["slstm_layers"] = stacked_init(block(init_slstm), ks[2], n_groups)
    return params


def _mlstm_block(p_l, cfg, x, mode, cache=None):
    x = gather_seq(x)
    h = rms_norm(x, p_l["ln"], cfg.norm_eps)
    if mode == "decode":
        m, c = mlstm_decode(p_l["cell"], cfg, h, cache)
    elif mode == "prefill":
        m, c = mlstm_forward(p_l["cell"], cfg, h, return_state=True)
    else:
        m, c = mlstm_forward(p_l["cell"], cfg, h), None
    return constrain(x + m, "activation"), c


def _slstm_block(p_l, cfg, x, mode, state=None):
    x = gather_seq(x)
    h = rms_norm(x, p_l["ln"], cfg.norm_eps)
    if mode == "decode":
        m, st = slstm_decode(p_l["cell"], cfg, h, state)
    elif mode == "prefill":
        m, st = slstm_forward(p_l["cell"], cfg, h, return_state=True)
    else:
        m, st = slstm_forward(p_l["cell"], cfg, h), None
    return constrain(x + m, "activation"), st


def _backbone(params, cfg, x, mode, caches=None):
    """Runs the groups, the tail and the final norm. Returns (x, caches):
    the prefill caches, or ``caches`` written in place by decode, or None
    in train mode. With ``cfg.remat`` each mLSTM block of a training
    forward runs under ``torch.utils.checkpoint``, as the JAX package
    checkpoints its mLSTM scan's body."""
    every, n_groups, n_mpg, n_tail = _layout(cfg)
    m_layers = unstack(params["mlstm_layers"]) if "mlstm_layers" in params else []
    s_layers = unstack(params["slstm_layers"]) if "slstm_layers" in params else []
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    m_caches, s_caches = [], []

    def mlstm(i, x):
        c_l = tree_map(lambda t: t[i], caches["mlstm"]) if mode == "decode" else None
        if remat:
            x, c = checkpoint(_mlstm_block, m_layers[i], cfg, x, mode, use_reentrant=False)
        else:
            x, c = _mlstm_block(m_layers[i], cfg, x, mode, c_l)
        m_caches.append(c)
        return x

    for g in range(n_groups):
        for i in range(g * n_mpg, (g + 1) * n_mpg):
            x = mlstm(i, x)
        s_l = tree_map(lambda t: t[g], caches["slstm"]) if mode == "decode" else None
        x, st = _slstm_block(s_layers[g], cfg, x, mode, s_l)
        s_caches.append(st)
    for i in range(n_groups * n_mpg, n_groups * n_mpg + n_tail):
        x = mlstm(i, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mode == "prefill":
        def stack(cs):
            return {k: torch.stack([c[k] for c in cs]) for k in cs[0]} if cs else None
        caches = {"mlstm": stack(m_caches), "slstm": stack(s_caches)}
    elif mode == "train":
        caches = None
    return x, caches


def xlstm_loss(params, cfg, batch):
    """Mean next-token CE over labels >= 0 (weighted by
    ``batch["client_weights"]`` per row where given). Returns (loss, {})."""
    x = embed(params["emb"], batch["tokens"])
    x, _ = _backbone(params, cfg, x, "train")
    logits = constrain(x @ params["head"], "logits")
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    if "client_weights" in batch:
        mask = mask * batch["client_weights"][:, None]
    return cross_entropy(logits, torch.clamp(labels, min=0), mask), {}


def xlstm_prefill(params, cfg, batch):
    """Logits of the last prompt position (B, 1, V) and the filled caches."""
    x = embed(params["emb"], batch["tokens"])
    x, caches = _backbone(params, cfg, x, "prefill")
    return constrain(x[:, -1:, :] @ params["head"], "logits"), caches


def init_xlstm_cache(params, cfg, batch_size, length, dtype):
    """Empty caches: mLSTM state and conv per layer, sLSTM state per group
    (None without groups); their size does not depend on ``length``."""
    del length
    every, n_groups, n_mpg, n_tail = _layout(cfg)
    device = params["final_norm"].device
    n_mlstm = n_groups * n_mpg + n_tail
    mc = {k: t.expand(n_mlstm, *t.shape).clone()
          for k, t in init_mlstm_cache(cfg, batch_size, dtype, device).items()}
    sc = None
    if n_groups:
        sc = {k: t.expand(n_groups, *t.shape).clone()
              for k, t in init_slstm_state(cfg, batch_size, dtype, device).items()}
    return {"mlstm": mc, "slstm": sc}


def xlstm_decode(params, cfg, token, pos, caches):
    """token: (B, 1) ints; pos is unused (the state carries the position).
    Writes the new state into ``caches`` in place and returns (logits
    (B, 1, V), caches)."""
    del pos
    x = embed(params["emb"], token)
    x, caches = _backbone(params, cfg, x, "decode", caches=caches)
    return constrain(x @ params["head"], "logits"), caches
