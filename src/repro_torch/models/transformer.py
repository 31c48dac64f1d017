"""Decoder-only LM assembly for the dense, MoE and MLA architectures.

Params keep the JAX package's tree, with the layers stacked on axis 0
(``params["dense_layers"]``, and ``params["moe_layers"]`` for an MoE
config after its ``first_dense_layers``), so ``interop.lm_params_from_numpy``
carries a JAX tree across by key. Where the JAX package ``lax.scan``s over
a stack, the port loops over it in Python, summing the MoE layers'
load-balance losses in layer order as the scan does. Its sharding
constraints sit where the JAX package's do
(``sharding.partition.constrain`` after each block and on the logits):
with no sharding context, or on plain tensors, they return their input.
On DTensor params (a ``sharding.partition.use_mesh`` run) every config
runs sharded, the MoE and MLA ones included. With
``cfg.use_mla`` (deepseek-v2-lite) every layer's attention is MLA
(``attention.mla_*``; decode absorbed under ``cfg.mla_absorb``). The vlm
family (phi-3-vision) is this dense LM with ``n_img_tokens``
image embeddings ahead of the text, which carry no loss. The hybrid
(``hybrid.py``), xLSTM (``xlstm_lm.py``) and encoder-decoder
(``encdec.py``) families have their own assemblies.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (cross_entropy, dtype_of, embed, init_embedding,
                                       init_swiglu, normal, rms_norm, stacked_init, swiglu)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.sharding.partition import constrain, gather_seq
from repro_torch.tree import tree_map, unstack

PORTED_ARCHS = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
# weight of the MoE load-balance loss in ``lm_loss`` (the JAX package's default)
AUX_WEIGHT = 0.01
STACKS = ("dense", "moe")


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for an arch type the JAX package does
    not have."""
    if cfg.arch_type not in PORTED_ARCHS:
        raise NotImplementedError(f"arch_type {cfg.arch_type!r} is not ported: it is not an "
                                  "arch type of the JAX package")


# ----------------------------------------------------------------- init

def _init_block(key, cfg, kind):
    ks = prng.split(key, 2)
    dt = dtype_of(cfg)
    ones = torch.ones(*key.shape[:-1], cfg.d_model, dtype=dt, device=key.device)
    ffn = (init_moe(ks[..., 1, :], cfg) if kind == "moe"
           else init_swiglu(ks[..., 1, :], cfg.d_model, cfg.d_ff, dt))
    init_attn = attn.init_mla if cfg.use_mla else attn.init_attention
    return {"ln1": ones, "ln2": ones.clone(), "attn": init_attn(ks[..., 0, :], cfg), "ffn": ffn}


def init_lm(key, cfg, device=None):
    """The JAX package's ``init_lm(key, cfg)``: the same model from the same
    key, drawn on ``device`` (``None`` means CUDA)."""
    check_ported(cfg)
    key = key.to(resolve_device(device))
    dt = dtype_of(cfg)
    k_emb, k_dense, k_moe, k_head = prng.split(key, 4)
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.n_layers
    n_moe = cfg.n_layers - n_dense if cfg.is_moe else 0
    params = {
        "emb": init_embedding(k_emb, cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=key.device),
    }
    if n_dense:
        params["dense_layers"] = stacked_init(lambda k: _init_block(k, cfg, "dense"), k_dense,
                                              n_dense)
    if n_moe:
        params["moe_layers"] = stacked_init(lambda k: _init_block(k, cfg, "moe"), k_moe, n_moe)
    if not cfg.tie_embeddings:
        params["head"] = normal(k_head, (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dt)
    return params


# ----------------------------------------------------------------- blocks

def _block_apply(p, cfg, x, positions, kind, mode, cache=None, pos=None):
    """One transformer block. Returns (x, new_cache, aux): aux is the MoE
    layer's load-balance loss, 0.0 for a dense layer."""
    x = gather_seq(x)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = None
    if cfg.use_mla:
        if mode == "train":
            a = attn.mla_train(p["attn"], cfg, h, positions)
        elif mode == "prefill":
            a, new_cache = attn.mla_prefill(p["attn"], cfg, h, positions)
        else:
            a, new_cache = attn.mla_decode(p["attn"], cfg, h, pos, cache, absorb=cfg.mla_absorb)
    elif mode == "train":
        a = attn.attn_train(p["attn"], cfg, h, positions)
    elif mode == "prefill":
        a, new_cache = attn.attn_prefill(p["attn"], cfg, h, positions)
    else:
        a, new_cache = attn.attn_decode(p["attn"], cfg, h, pos, cache)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        f, aux = moe_ffn(p["ffn"], cfg, h, groups=cfg.moe_groups)
    else:
        f, aux = swiglu(p["ffn"], h), 0.0
    return constrain(x + f, "activation"), new_cache, aux


def lm_backbone(params, cfg, x, positions, mode, caches=None, pos=None):
    """Runs the dense stack, then the MoE stack, then the final norm.
    Returns (x, aux, caches): the summed MoE load-balance loss (0.0 without
    MoE layers) and the prefill caches ``{"dense", "moe"}`` stacked on axis
    0, or ``caches`` written in place by decode, or {} in train mode. With
    ``cfg.remat`` each layer of a training forward runs under
    ``torch.utils.checkpoint``, as the JAX package ``jax.checkpoint``s its
    scan body: less memory, same values."""
    check_ported(cfg)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    new_caches = {}
    for kind in STACKS:
        if f"{kind}_layers" not in params:
            continue
        stacked = caches[kind] if mode == "decode" else None
        new = []
        for i, p_l in enumerate(unstack(params[f"{kind}_layers"])):
            c_l = tree_map(lambda t: t[i], stacked) if stacked is not None else None
            if remat:
                x, c, aux = checkpoint(_block_apply, p_l, cfg, x, positions, kind, mode,
                                       use_reentrant=False)
            else:
                x, c, aux = _block_apply(p_l, cfg, x, positions, kind, mode, cache=c_l, pos=pos)
            aux_total = aux_total + aux
            new.append(c)
        if mode == "prefill":
            new_caches[kind] = {name: torch.stack([c[name] for c in new]) for name in new[0]}
    if mode == "decode":
        new_caches = caches
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total, new_caches


def lm_logits(params, cfg, x):
    head = params.get("head")
    return constrain(x @ (head if head is not None else params["emb"]["tok"].T), "logits")


# ----------------------------------------------------------------- entry

def embed_inputs(params, cfg, batch):
    """tokens -> (B, S, d) activations; with ``cfg.n_img_tokens`` and
    ``batch["img_embeds"]`` (B, n_img, d) the image embeddings, cast to the
    activations' dtype, go ahead of the text."""
    x = embed(params["emb"], batch["tokens"])
    if cfg.n_img_tokens and "img_embeds" in batch:
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
    return x


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def lm_loss(params, cfg, batch):
    """Mean next-token CE over labels >= 0 (weighted by
    ``batch["client_weights"]`` per row where given), plus ``AUX_WEIGHT``
    times the MoE load-balance loss for an MoE config. Labels shorter than
    the sequence (a vlm's text after its image embeddings) are padded on
    the left with -1, so the image positions carry no loss. Returns (loss,
    {"aux": aux}); aux is 0.0 without MoE layers."""
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    x, aux, _ = lm_backbone(params, cfg, x, _positions(B, S, x.device), "train")
    logits = lm_logits(params, cfg, x)
    labels = batch["labels"]
    if labels.shape[1] < S:
        labels = torch.cat([labels.new_full((B, S - labels.shape[1]), -1), labels], dim=1)
    mask = (labels >= 0).to(torch.float32)
    if "client_weights" in batch:
        mask = mask * batch["client_weights"][:, None]
    loss = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    if cfg.is_moe:
        loss = loss + AUX_WEIGHT * aux
    return loss, {"aux": aux}


def lm_prefill(params, cfg, batch):
    """Logits of the last prompt position (B, 1, V) and the filled caches."""
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    x, _, caches = lm_backbone(params, cfg, x, _positions(B, S, x.device), "prefill")
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def init_lm_cache(params, cfg, batch_size, length, dtype, per_row=False):
    """Empty caches for every layer of each stack, stacked on axis 0: the
    compressed MLA caches with ``cfg.use_mla``, else GQA K/V caches, whose
    positions are (B, length) with ``per_row`` (each row decodes at its own
    position; MLA caches refuse it)."""
    init_cache = attn.init_mla_cache if cfg.use_mla else attn.init_cache
    caches = {}
    for kind in STACKS:
        if f"{kind}_layers" not in params:
            continue
        ln1 = params[f"{kind}_layers"]["ln1"]
        one = init_cache(cfg, batch_size, length, dtype, ln1.device, per_row=per_row)
        caches[kind] = {name: t.expand(ln1.shape[0], *t.shape).clone() for name, t in one.items()}
    return caches


def lm_decode(params, cfg, token, pos, caches):
    """token: (B, 1) ints; pos: the absolute position (int) shared by every
    row, or each row's own as a (B,) int tensor for a per-row cache
    (``init_lm_cache(per_row=True)``). Writes the new slot into ``caches``
    in place (it consumes the caches it is given) and returns (logits
    (B, 1, V), caches)."""
    x = embed(params["emb"], token)
    x, _, caches = lm_backbone(params, cfg, x, None, "decode", caches=caches, pos=pos)
    return lm_logits(params, cfg, x), caches
