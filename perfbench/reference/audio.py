"""The whisper family: an encoder over stub frame embeddings (plus
sinusoids; bidirectional self-attention and a GELU MLP, pre-LayerNorm)
and a decoder over text (token embeddings plus sinusoids; causal
self-attention, cross-attention to every encoder frame, GELU MLP). No
RoPE; every projection has a bias."""

from __future__ import annotations

import torch

from perfbench.reference.common import (attention, cross_entropy, gelu_mlp, init_gelu_mlp,
                                        layer_norm, sinusoids, token_mask, unstack)


def _ln(draw, lead, d, dt):
    return {"scale": draw.full(lead, d, 1.0, dt), "bias": draw.full(lead, d, 0.0, dt)}


def _attn(draw, lead, cfg):
    d, H, KV, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.dtype
    p = {"wq": draw.normal(lead, (d, H * hd), d ** -0.5, dt),
         "wk": draw.normal(lead, (d, KV * hd), d ** -0.5, dt),
         "wv": draw.normal(lead, (d, KV * hd), d ** -0.5, dt),
         "wo": draw.normal(lead, (H * hd, d), (H * hd) ** -0.5, dt)}
    for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd), ("bo", d)):
        p[name] = draw.full(lead, n, 0.0, dt)
    return p


def init(draw, cfg):
    d, dt = cfg.d_model, cfg.dtype
    E, L = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "enc_layers": {"ln1": _ln(draw, E, d, dt), "attn": _attn(draw, E, cfg),
                       "ln2": _ln(draw, E, d, dt), "mlp": init_gelu_mlp(draw, E, d, cfg.d_ff, dt)},
        "enc_norm": _ln(draw, (), d, dt),
        "emb": {"tok": draw.normal((), (cfg.padded_vocab, d), 0.02, dt)},
        "dec_layers": {"ln1": _ln(draw, L, d, dt), "self_attn": _attn(draw, L, cfg),
                       "ln_x": _ln(draw, L, d, dt), "cross_attn": _attn(draw, L, cfg),
                       "ln2": _ln(draw, L, d, dt), "mlp": init_gelu_mlp(draw, L, d, cfg.d_ff, dt)},
        "dec_norm": _ln(draw, (), d, dt),
        "head": draw.normal((), (d, cfg.padded_vocab), d ** -0.5, dt),
    }


def _norm(x, p, cfg):
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def _mha(p, cfg, x, kv, causal):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T = kv.shape[1]
    q = (x @ p["wq"] + p["bq"]).reshape(B, S, H, hd)
    k = (kv @ p["wk"] + p["bk"]).reshape(B, T, KV, hd)
    v = (kv @ p["wv"] + p["bv"]).reshape(B, T, KV, hd)
    return attention(q, k, v, hd ** -0.5, causal).reshape(B, S, H * hd) @ p["wo"] + p["bo"]


def hidden(params, cfg, batch):
    frames = batch["frames"]
    B, T, d = frames.shape
    x = frames + sinusoids(T, d, frames.device).to(frames.dtype)
    for p in unstack(params["enc_layers"], cfg.n_enc_layers):
        h = _norm(x, p["ln1"], cfg)
        x = x + _mha(p["attn"], cfg, h, h, causal=False)
        x = x + gelu_mlp(p["mlp"], _norm(x, p["ln2"], cfg))
    enc = _norm(x, params["enc_norm"], cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = params["emb"]["tok"][tokens] + sinusoids(S, d, frames.device).to(frames.dtype)
    for p in unstack(params["dec_layers"], cfg.n_layers):
        h = _norm(x, p["ln1"], cfg)
        x = x + _mha(p["self_attn"], cfg, h, h, causal=True)
        x = x + _mha(p["cross_attn"], cfg, _norm(x, p["ln_x"], cfg), enc, causal=False)
        x = x + gelu_mlp(p["mlp"], _norm(x, p["ln2"], cfg))
    return _norm(x, params["dec_norm"], cfg)


def loss(params, cfg, batch):
    labels = batch["labels"]
    logits = hidden(params, cfg, batch) @ params["head"]
    return cross_entropy(logits, torch.clamp(labels, min=0),
                         token_mask(labels, batch, cfg.vocab_size))


def last_logits(params, cfg, batch):
    return hidden(params, cfg, batch)[:, -1] @ params["head"]


def forward_flops(cfg, S: int) -> int:
    """Matmul and attention FLOPs of one row's forward: the encoder over
    ``cfg.enc_frames`` frames (q, k, v, o, the MLP, every frame pair), the
    decoder's S positions (self and cross q, o; the cross k, v over the
    frames; the MLP; causal pairs and every (position, frame) pair) and
    the head."""
    from perfbench.harness import arith

    d, T, H, hd = cfg.d_model, cfg.enc_frames, cfg.n_heads, cfg.hd
    mlp = 2 * 2 * d * cfg.d_ff
    enc = cfg.n_enc_layers * (T * (4 * 2 * d * d + mlp) + arith.attn_pairs_flops(T * T, H, hd, hd))
    dec = cfg.n_layers * (S * (4 * 2 * d * d + 2 * 2 * d * d + mlp) + T * 2 * 2 * d * d
                          + arith.attn_pairs_flops(arith.causal_pairs(S) + S * T, H, hd, hd))
    return enc + dec + 2 * S * d * cfg.padded_vocab
