"""GQA attention of the LMs: qk-norm, qkv-bias, RoPE, sliding window, and
per-invocation LoRA adapters on q/k/v (the zamba2 shared block).

Three entry modes, as in the JAX package:
  * ``attn_train``   — full-sequence causal (the forward loss)
  * ``attn_prefill`` — full-sequence causal, also returns the filled KV cache
  * ``attn_decode``  — ONE new token against a fixed-size cache

The cache is a dict ``{"k", "v", "positions"}`` of length W. Slots roll
(slot = pos % W), so W == cfg.sliding_window gives the window by
overwrite. Keys are stored RoPE'd at their absolute positions.
``attn_decode`` writes the new slot into the cache it is given, in place.

``attn_train`` runs the ``flash_attention`` kernel when ``cfg.use_pallas``
is set and S % 128 == 0, the JAX package's gate; otherwise, and in prefill
and decode, the model's own chunked softmax attention ``_sdpa_chunked``.
MLA and cross-attention are not ported (ROADMAP queue 1 item 11);
per-row (continuous-batching) decode is item 13.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dtype_of, normal, rms_norm

Q_CHUNK = 512
PER_ROW_DECODE = ("per-row (continuous-batching) decode is not ported yet "
                  "(launch/queue.py, ROADMAP queue 1 item 13)")


def _bias(y, p, name):
    return y + p[name] if name in p else y


def _maybe_lora(w, lora, name):
    if lora is None or f"a_{name}" not in lora:
        return w
    return w + lora[f"a_{name}"] @ lora[f"b_{name}"]


def init_attention(key, cfg):
    """GQA projection params; key (..., 2) -> leaves with leading axes."""
    dt = dtype_of(cfg)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = tuple(key.shape[:-1])
    ks = prng.split(key, 4)
    std = d ** -0.5
    p = {
        "wq": normal(ks[..., 0, :], (d, H * hd), std, dt),
        "wk": normal(ks[..., 1, :], (d, KV * hd), std, dt),
        "wv": normal(ks[..., 2, :], (d, KV * hd), std, dt),
        "wo": normal(ks[..., 3, :], (H * hd, d), (H * hd) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd), ("bo", d)):
            p[name] = torch.zeros(*lead, n, dtype=dt, device=key.device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, hd, dtype=dt, device=key.device)
        p["k_norm"] = torch.ones(*lead, hd, dtype=dt, device=key.device)
    return p


def init_attention_lora(key, cfg, n_slots, rank):
    """Per-invocation LoRA adapters for a shared attention block (zamba2):
    ``a_*`` (n_slots, d, rank) drawn, ``b_*`` (n_slots, rank, out) zero."""
    dt = dtype_of(cfg)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lead = tuple(key.shape[:-1])
    ks = prng.split(key, 3)
    std = d ** -0.5

    def one(k, out):
        kab = prng.split(k, 2)
        return (normal(kab[..., 0, :], (n_slots, d, rank), std, dt),
                torch.zeros(*lead, n_slots, rank, out, dtype=dt, device=key.device))

    aq, bq = one(ks[..., 0, :], H * hd)
    ak, bk = one(ks[..., 1, :], KV * hd)
    av, bv = one(ks[..., 2, :], KV * hd)
    return {"a_q": aq, "b_q": bq, "a_k": ak, "b_k": bk, "a_v": av, "b_v": bv}


def _project_qkv(p, cfg, x, lora=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _bias(x @ _maybe_lora(p["wq"], lora, "q"), p, "bq").reshape(B, S, H, hd)
    k = _bias(x @ _maybe_lora(p["wk"], lora, "k"), p, "bk").reshape(B, S, KV, hd)
    v = _bias(x @ _maybe_lora(p["wv"], lora, "v"), p, "bv").reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _sdpa_chunked(q, k, v, q_pos, k_pos, scale, causal=True, window=0, chunk=Q_CHUNK):
    """Chunked softmax attention. q: (B, Sq, H, hd); k, v: (B, Sk, KV, *).

    GQA via reshape; scores masked with absolute positions (k_pos < 0 =
    invalid slot). Queries go in chunks of ``chunk`` rows, so live memory
    is O(chunk x Sk). Scores and both products are f32 (the operands are
    cast up, which is exact); the probabilities are rounded to v's dtype
    before the PV product, as in the JAX package.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    valid = k_pos[None, :] >= 0
    outs = []
    for c0 in range(0, Sq, chunk):
        qp = q_pos[c0:c0 + chunk, None]
        s = torch.einsum("bqkgh,bskh->bkgqs", qr[:, c0:c0 + chunk].to(torch.float32), kf) * scale
        mask = valid
        if causal:
            mask = mask & (k_pos[None, :] <= qp)
        if window:
            mask = mask & (k_pos[None, :] > qp - window)
        s = s.masked_fill(~mask, -1e30)
        p_attn = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", p_attn, vf).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, dv)


def attn_train(p, cfg, x, positions, lora=None):
    q, k, v = _project_qkv(p, cfg, x, lora)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    if cfg.use_pallas and S % 128 == 0:
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True).transpose(1, 2)
    else:
        o = _sdpa_chunked(q, k, v, positions[0], positions[0], cfg.hd ** -0.5,
                          causal=True, window=0)
    return _bias(o.reshape(B, S, -1) @ p["wo"], p, "bo")


def attn_prefill(p, cfg, x, positions, lora=None):
    q, k, v = _project_qkv(p, cfg, x, lora)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _sdpa_chunked(q, k, v, positions[0], positions[0], cfg.hd ** -0.5)
    B, S = x.shape[:2]
    y = _bias(o.reshape(B, S, -1) @ p["wo"], p, "bo")
    return y, {"k": k, "v": v, "positions": positions[0]}


def init_cache(cfg, batch, length, dtype, device, per_row=False):
    """An empty cache of ``length`` slots (positions -1 = empty)."""
    if per_row:
        raise NotImplementedError(PER_ROW_DECODE)
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "positions": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def attn_decode(p, cfg, x, pos, cache, lora=None):
    """x: (B, 1, d); pos: the absolute position (int) shared by every row.
    Writes slot ``pos % W`` of ``cache`` in place and returns it."""
    if cache["positions"].ndim == 2:
        raise NotImplementedError(PER_ROW_DECODE)
    B = x.shape[0]
    W = cache["k"].shape[1]
    pos = int(pos)
    q, k, v = _project_qkv(p, cfg, x, lora)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = pos % W
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["positions"][slot].fill_(pos)       # a fill kernel: no host copy
    o = _sdpa_chunked(q, cache["k"], cache["v"], posv[0], cache["positions"], cfg.hd ** -0.5,
                      causal=True, window=cfg.sliding_window)
    return _bias(o.reshape(B, 1, -1) @ p["wo"], p, "bo"), cache
