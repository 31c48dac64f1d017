"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

As in the JAX package: the batch supplies precomputed post-conv frame
embeddings ``frames`` (B, enc_frames, d_model); the mel and conv feature
extractor is out of scope. Positions are sinusoidal (the encoder's and a
prefill's from the float64 table, a decode step's computed in f32 at its
position); LayerNorm and GELU MLPs; no RoPE. Every attention is the
model's chunked softmax attention, as the JAX package sends none of this
family to a kernel.

Params keep the JAX package's tree, layers stacked on axis 0
(``enc_layers``, ``dec_layers``), so ``interop.lm_params_from_numpy``
carries it across by key. Where the JAX package ``lax.scan``s over a
stack, the port loops in Python. The caches are ``{"self": ..., "cross":
...}``: the decoder's self-attention K/V with positions, and the encoder
K/V each decoder layer's cross-attention reads; decode writes the self
caches in place and reuses the cross K/V of prefill.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import _bias
from repro_torch.models.layers import (cross_entropy, dtype_of, embed, gelu_mlp, init_embedding,
                                       init_gelu_mlp, layer_norm, normal, sinusoidal_positions,
                                       stacked_init)
from repro_torch.sharding.partition import (constrain, gather_seq, merge_heads, split_heads,
                                            write_slot)
from repro_torch.tree import tree_map, unstack


def _ln_params(lead, d, dt, device):
    return {"scale": torch.ones(*lead, d, dtype=dt, device=device),
            "bias": torch.zeros(*lead, d, dtype=dt, device=device)}


def _ln(x, p, cfg):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _init_enc_layer(key, cfg):
    ks = prng.split(key, 2)
    dt, lead, d = dtype_of(cfg), tuple(key.shape[:-1]), cfg.d_model
    return {
        "ln1": _ln_params(lead, d, dt, key.device),
        "attn": attn.init_attention(ks[..., 0, :], cfg, cross=True),
        "ln2": _ln_params(lead, d, dt, key.device),
        "mlp": init_gelu_mlp(ks[..., 1, :], d, cfg.d_ff, dt),
    }


def _init_dec_layer(key, cfg):
    ks = prng.split(key, 3)
    dt, lead, d = dtype_of(cfg), tuple(key.shape[:-1]), cfg.d_model
    return {
        "ln1": _ln_params(lead, d, dt, key.device),
        "self_attn": attn.init_attention(ks[..., 0, :], cfg, cross=True),
        "ln_x": _ln_params(lead, d, dt, key.device),
        "cross_attn": attn.init_attention(ks[..., 1, :], cfg, cross=True),
        "ln2": _ln_params(lead, d, dt, key.device),
        "mlp": init_gelu_mlp(ks[..., 2, :], d, cfg.d_ff, dt),
    }


def init_encdec(key, cfg, device=None):
    """The JAX package's ``init_encdec(key, cfg)``: the same model from the
    same key (five keys split, four used), drawn on ``device`` (``None``
    means CUDA)."""
    key = key.to(resolve_device(device))
    dt = dtype_of(cfg)
    ks = prng.split(key, 5)
    return {
        "enc_layers": stacked_init(lambda k: _init_enc_layer(k, cfg), ks[0], cfg.n_enc_layers),
        "enc_norm": _ln_params((), cfg.d_model, dt, key.device),
        "emb": init_embedding(ks[1], cfg.padded_vocab, cfg.d_model, dt),
        "dec_layers": stacked_init(lambda k: _init_dec_layer(k, cfg), ks[2], cfg.n_layers),
        "dec_norm": _ln_params((), cfg.d_model, dt, key.device),
        "head": normal(ks[3], (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dt),
    }


def _self_attn_norope(p, cfg, h, causal, cache=None, pos=None, window=0):
    """Whisper's self-attention, no RoPE: full sequence (train, prefill;
    returns the filled cache) or one decode step (writes slot ``pos % W``
    of ``cache`` in place and returns it)."""
    S = h.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(_bias(h @ p["wq"], p, "bq"), H, hd)
    k = split_heads(_bias(h @ p["wk"], p, "bk"), KV, hd)
    v = split_heads(_bias(h @ p["wv"], p, "bv"), KV, hd)
    if cache is None:
        pos_ix = torch.arange(S, dtype=torch.int32, device=h.device)
        o = attn.attend(q, k, v, pos_ix, pos_ix, hd ** -0.5, causal=causal, window=window)
        cache = {"k": k, "v": v, "positions": pos_ix}
    else:
        slot = pos % cache["k"].shape[1]
        write_slot(cache["k"], 1, slot, k[:, 0])
        write_slot(cache["v"], 1, slot, v[:, 0])
        write_slot(cache["positions"], 0, slot, pos)   # a fill kernel: no host copy
        qpos = torch.full((S,), pos, dtype=torch.int32, device=h.device)
        o = attn.attend(q, cache["k"], cache["v"], qpos, cache["positions"], hd ** -0.5,
                        causal=True, window=window)
    return _bias(merge_heads(o) @ p["wo"], p, "bo"), cache


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _enc_layer(p_l, cfg, x):
    x = gather_seq(x)
    a, _ = _self_attn_norope(p_l["attn"], cfg, _ln(x, p_l["ln1"], cfg), causal=False)
    x = x + a
    return constrain(x + gelu_mlp(p_l["mlp"], _ln(x, p_l["ln2"], cfg)), "activation")


def encode(params, cfg, frames):
    """frames: (B, T, d_model) stub embeddings -> encoder states. With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` where
    autograd records, as the JAX package ``jax.checkpoint``s its scan body."""
    B, T, d = frames.shape
    x = frames + sinusoidal_positions(T, d, frames.device).to(frames.dtype)
    for p_l in unstack(params["enc_layers"]):
        if _remat(cfg):
            x = checkpoint(_enc_layer, p_l, cfg, x, use_reentrant=False)
        else:
            x = _enc_layer(p_l, cfg, x)
    return _ln(x, params["enc_norm"], cfg)


def _dec_layer(p_l, cfg, x, enc_or_kv, mode, self_c=None, pos=None):
    """One decoder layer; returns (x, self cache, cross K/V)."""
    x = gather_seq(x)
    a, new_self = _self_attn_norope(p_l["self_attn"], cfg, _ln(x, p_l["ln1"], cfg), causal=True,
                                    cache=self_c, pos=pos,
                                    window=cfg.sliding_window if mode == "decode" else 0)
    x = x + a
    kv = enc_or_kv if mode == "decode" else attn.cross_kv(p_l["cross_attn"], cfg, enc_or_kv)
    x = x + attn.cross_attn(p_l["cross_attn"], cfg, _ln(x, p_l["ln_x"], cfg), kv)
    x = constrain(x + gelu_mlp(p_l["mlp"], _ln(x, p_l["ln2"], cfg)), "activation")
    return x, new_self, kv


def _decoder(params, cfg, x, enc, mode, caches=None, pos=None):
    """Runs the decoder stack and its final norm. ``enc``: the encoder
    states (train, prefill) or None (decode, which reads each layer's
    cross K/V from ``caches["cross"]``). Returns (x, caches): prefill's
    ``{"self", "cross"}`` stacked on axis 0, decode's ``caches`` written in
    place, None in train mode."""
    selfs, crosses = [], []
    for i, p_l in enumerate(unstack(params["dec_layers"])):
        if mode == "decode":
            self_c = tree_map(lambda t: t[i], caches["self"])
            kv = (caches["cross"]["k"][i], caches["cross"]["v"][i])
            x, _, _ = _dec_layer(p_l, cfg, x, kv, mode, self_c, pos)
        elif mode == "train" and _remat(cfg):
            x = checkpoint(lambda p, h: _dec_layer(p, cfg, h, enc, mode)[0], p_l, x,
                           use_reentrant=False)
        else:
            x, new_self, kv = _dec_layer(p_l, cfg, x, enc, mode)
            selfs.append(new_self)
            crosses.append(kv)
    x = _ln(x, params["dec_norm"], cfg)
    if mode == "prefill":
        caches = {"self": {name: torch.stack([c[name] for c in selfs]) for name in selfs[0]},
                  "cross": {"k": torch.stack([kv[0] for kv in crosses]),
                            "v": torch.stack([kv[1] for kv in crosses])}}
    return x, caches if mode != "train" else None


def _embed_text(params, cfg, tokens):
    S = tokens.shape[1]
    x = embed(params["emb"], tokens)
    return x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)


def encdec_loss(params, cfg, batch):
    """Mean next-token CE over labels in [0, vocab_size) (weighted by
    ``batch["client_weights"]`` per row where given), of the decoder on
    the encoded ``batch["frames"]``. Returns (loss, {})."""
    enc = encode(params, cfg, batch["frames"])
    x, _ = _decoder(params, cfg, _embed_text(params, cfg, batch["tokens"]), enc, "train")
    logits = constrain(x @ params["head"], "logits")
    labels = batch["labels"]
    mask = ((labels >= 0) & (labels < cfg.vocab_size)).to(torch.float32)
    if "client_weights" in batch:
        mask = mask * batch["client_weights"][:, None]
    return cross_entropy(logits, torch.clamp(labels, min=0), mask), {}


def encdec_prefill(params, cfg, batch):
    """Logits of the last prompt position (B, 1, V) and the caches."""
    enc = encode(params, cfg, batch["frames"])
    x, caches = _decoder(params, cfg, _embed_text(params, cfg, batch["tokens"]), enc, "prefill")
    return constrain(x[:, -1:, :] @ params["head"], "logits"), caches


def init_encdec_cache(params, cfg, batch_size, length, dtype):
    """Empty caches: the decoder's self K/V of ``length`` slots (the window
    where ``cfg.sliding_window`` is shorter) and zero cross K/V of
    ``cfg.enc_frames`` frames, per decoder layer."""
    kv_len = min(length, cfg.sliding_window) if cfg.sliding_window else length
    dev = params["dec_norm"]["scale"].device
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    one = attn.init_cache(cfg, batch_size, kv_len, dtype, dev)
    cross = (L, batch_size, cfg.enc_frames, KV, hd)
    return {"self": {name: t.expand(L, *t.shape).clone() for name, t in one.items()},
            "cross": {"k": torch.zeros(cross, dtype=dtype, device=dev),
                      "v": torch.zeros(cross, dtype=dtype, device=dev)}}


def decode_positions(pos: int, d: int, device) -> torch.Tensor:
    """The sinusoid at position ``pos`` (d,), computed in f32 on the fly as
    the JAX package's ``encdec_decode`` computes it."""
    idx = torch.arange(d, device=device)
    ang = torch.full((), pos, dtype=torch.float32, device=device) / torch.pow(
        10_000.0, 2 * (idx // 2) / d)
    return torch.where(idx % 2 == 0, torch.sin(ang), torch.cos(ang))


def encdec_decode(params, cfg, token, pos, caches):
    """token: (B, 1) ints; pos: the absolute position (int). Writes the new
    self-attention slot into ``caches`` in place and returns (logits (B, 1,
    V), caches)."""
    pos = int(pos)
    x = embed(params["emb"], token)
    x = x + decode_positions(pos, cfg.d_model, x.device).to(x.dtype)
    x, caches = _decoder(params, cfg, x, None, "decode", caches=caches, pos=pos)
    return constrain(x @ params["head"], "logits"), caches
