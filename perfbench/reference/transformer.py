"""The decoder-only LM of the dense, vlm and moe families: pre-norm blocks
of attention (grouped-query with RoPE, or DeepSeek-V2's multi-head latent
attention) and an FFN (SwiGLU, or routed experts with shared experts
after the first dense layers); a vlm takes image embeddings ahead of its
text.

The MoE layer is the port's capacity dispatch: a softmax router in f32,
each token's top-k experts (normalised where ``norm_topk``), then each
expert's top-C tokens by gate (C = ceil(n k / E * capacity_factor), at
least 8, at most n), ties to the lower index; tokens beyond capacity are
dropped. The loss adds 0.01 times the switch load-balance loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import (F32, apply_rope, attention, cross_entropy,
                                        init_swiglu, positions, rms_norm, swiglu,
                                        token_mask, unstack)

AUX_WEIGHT = 0.01


def _init_attention(draw, lead, cfg):
    d, H, KV, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.dtype
    p = {"wq": draw.normal(lead, (d, H * hd), d ** -0.5, dt),
         "wk": draw.normal(lead, (d, KV * hd), d ** -0.5, dt),
         "wv": draw.normal(lead, (d, KV * hd), d ** -0.5, dt),
         "wo": draw.normal(lead, (H * hd, d), (H * hd) ** -0.5, dt)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd), ("bo", d)):
            p[name] = draw.full(lead, n, 0.0, dt)
    if cfg.qk_norm:
        p["q_norm"] = draw.full(lead, hd, 1.0, dt)
        p["k_norm"] = draw.full(lead, hd, 1.0, dt)
    return p


def _init_mla(draw, lead, cfg):
    d, H, r, dt = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.dtype
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq": draw.normal(lead, (d, H * (dn + dr)), d ** -0.5, dt),
            "wkv_a": draw.normal(lead, (d, r + dr), d ** -0.5, dt),
            "kv_norm": draw.full(lead, r, 1.0, dt),
            "wkv_b": draw.normal(lead, (r, H * (dn + dv)), r ** -0.5, dt),
            "wo": draw.normal(lead, (H * dv, d), (H * dv) ** -0.5, dt)}


def _init_moe(draw, lead, cfg):
    d, f, E, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.dtype
    p = {"router": draw.normal(lead, (d, E), d ** -0.5, F32),
         "gate": draw.normal(lead, (E, d, f), d ** -0.5, dt),
         "up": draw.normal(lead, (E, d, f), d ** -0.5, dt),
         "down": draw.normal(lead, (E, f, d), f ** -0.5, dt)}
    if cfg.n_shared_experts:
        p["shared"] = init_swiglu(draw, lead, d, f * cfg.n_shared_experts, dt)
    return p


def _init_block(draw, n, cfg, kind):
    lead = (n,)
    return {"ln1": draw.full(lead, cfg.d_model, 1.0, cfg.dtype),
            "ln2": draw.full(lead, cfg.d_model, 1.0, cfg.dtype),
            "attn": (_init_mla if cfg.use_mla else _init_attention)(draw, lead, cfg),
            "ffn": (_init_moe(draw, lead, cfg) if kind == "moe"
                    else init_swiglu(draw, lead, cfg.d_model, cfg.d_ff, cfg.dtype))}


def _stacks(cfg):
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.n_layers
    return {"dense": n_dense, "moe": cfg.n_layers - n_dense}


def init(draw, cfg):
    dt = cfg.dtype
    params = {"emb": {"tok": draw.normal((), (cfg.padded_vocab, cfg.d_model), 0.02, dt)},
              "final_norm": draw.full((), cfg.d_model, 1.0, dt)}
    for kind, n in _stacks(cfg).items():
        if n:
            params[f"{kind}_layers"] = _init_block(draw, n, cfg, kind)
    if not cfg.tie_embeddings:
        params["head"] = draw.normal((), (cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dt)
    return params


def _gqa(p, cfg, x, pos):
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S, _ = x.shape

    def proj(w, b, n):
        y = x @ p[w]
        return (y + p[b] if b in p else y).reshape(B, S, n, hd)

    q, k, v = proj("wq", "bq", H), proj("wk", "bk", KV), proj("wv", "bv", KV)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
    o = attention(q, k, v, hd ** -0.5, causal=True).reshape(B, S, H * hd) @ p["wo"]
    return o + p["bo"] if "bo" in p else o


def _mla(p, cfg, x, pos):
    B, S, _ = x.shape
    H, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], apply_rope(q[..., dn:], pos, cfg.rope_theta)], dim=-1)
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., r:], pos, cfg.rope_theta)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    o = attention(q, k, kv[..., dn:], (dn + dr) ** -0.5, causal=True)
    return o.reshape(B, S, H * dv) @ p["wo"]


def _top(x, k):
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_ffn(p, cfg, x):
    """Routed experts with capacity, then the shared experts. Returns
    (y, load-balance loss)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    n, E, k = B * S, cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf.to(F32) @ p["router"].to(F32), dim=-1)          # (n, E)
    topv, topi = _top(probs, k)
    if cfg.norm_topk:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros(n, E, dtype=F32, device=x.device).scatter(1, topi, topv)
    cap = min(n, max(8, math.ceil(n * k / E * cfg.capacity_factor)))
    w_sel, idx = _top(gates.T, cap)                                         # (E, C)
    out = torch.zeros(n, d, dtype=x.dtype, device=x.device)
    for e in range(E):
        xs = xf[idx[e]]
        h = F.silu(xs @ p["gate"][e]) * (xs @ p["up"][e])
        out = out.index_add(0, idx[e], (h @ p["down"][e]) * w_sel[e, :, None].to(x.dtype))
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], xf)
    frac = F.one_hot(topi[:, 0], E).to(F32).mean(0)
    aux = E * torch.sum(frac * probs.mean(0))
    return out.reshape(B, S, d), aux


def hidden(params, cfg, batch):
    """The final-normed hidden states (B, S, d) and the summed load-balance
    loss; image embeddings go ahead of the text."""
    x = params["emb"]["tok"][batch["tokens"]]
    if cfg.n_img_tokens and "img_embeds" in batch:
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    pos = positions(B, S, x.device)
    aux = 0.0
    for kind, n in _stacks(cfg).items():
        for p in unstack(params[f"{kind}_layers"], n) if n else ():
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + (_mla if cfg.use_mla else _gqa)(p["attn"], cfg, h, pos)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            if kind == "moe":
                f, a = moe_ffn(p["ffn"], cfg, h)
                aux = aux + a
            else:
                f = swiglu(p["ffn"], h)
            x = x + f
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _head(params):
    return params["head"] if "head" in params else params["emb"]["tok"].T


def loss(params, cfg, batch):
    x, aux = hidden(params, cfg, batch)
    B, S = x.shape[:2]
    labels = batch["labels"]
    if labels.shape[1] < S:
        labels = torch.cat([labels.new_full((B, S - labels.shape[1]), -1), labels], dim=1)
    out = cross_entropy(x @ _head(params), torch.clamp(labels, min=0), token_mask(labels, batch))
    return out + AUX_WEIGHT * aux if cfg.is_moe else out


def last_logits(params, cfg, batch):
    """Logits of the last position (B, V)."""
    x, _ = hidden(params, cfg, batch)
    return x[:, -1] @ _head(params)


def forward_flops(cfg, S: int) -> int:
    """Matmul and attention FLOPs of one sequence's forward at S positions
    (S counts a vlm's image slots): each layer's attention projections and
    kept causal pairs, its SwiGLU (or router, top-k and shared experts),
    and the head."""
    from perfbench.harness import arith

    d = cfg.d_model
    n_dense = cfg.first_dense_layers if cfg.is_moe else cfg.n_layers
    if cfg.use_mla:
        proj = arith.mla_proj_flops(cfg)
        pairs = arith.attn_pairs_flops(arith.causal_pairs(S), cfg.n_heads,
                                       cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                       cfg.v_head_dim)
    else:
        proj = arith.gqa_proj_flops(cfg)
        pairs = arith.attn_pairs_flops(arith.causal_pairs(S), cfg.n_heads, cfg.hd, cfg.hd)
    attn = S * proj + pairs
    dense = n_dense * (attn + S * arith.swiglu_flops(d, cfg.d_ff))
    experts = (2 * d * cfg.n_experts + cfg.top_k * arith.swiglu_flops(d, cfg.moe_d_ff)
               + arith.swiglu_flops(d, cfg.moe_d_ff * cfg.n_shared_experts))
    moe = (cfg.n_layers - n_dense) * (attn + S * experts)
    return dense + moe + 2 * S * d * cfg.padded_vocab
