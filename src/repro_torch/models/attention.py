"""Attention of the LMs: GQA (qk-norm, qkv-bias, RoPE, sliding window, and
per-invocation LoRA adapters on q/k/v for the zamba2 shared block), MLA
(deepseek-v2) and whisper's cross-attention.

Three entry modes, as in the JAX package:
  * ``attn_train``   — full-sequence causal (the forward loss)
  * ``attn_prefill`` — full-sequence causal, also returns the filled KV cache
  * ``attn_decode``  — ONE new token against a fixed-size cache

The cache is a dict ``{"k", "v", "positions"}`` of length W. Slots roll
(slot = pos % W), so W == cfg.sliding_window gives the window by
overwrite. Keys are stored RoPE'd at their absolute positions.
``attn_decode`` writes the new slot into the cache it is given, in place.
A per-row cache (``init_cache(per_row=True)``, positions (B, W)) lets
each row decode at its own position (continuous batching,
``launch/queue.py``); its attention is ``_sdpa_decode_perrow``.

``attn_train`` runs the ``flash_attention`` kernel when ``cfg.use_pallas``
is set and S % 128 == 0, the JAX package's gate; otherwise, and in prefill
and decode, the model's own chunked softmax attention ``_sdpa_chunked``.
On DTensors either runs on the local shards
(``sharding.partition.on_local_shards``).
MLA (q/k heads of nope + rope width, a compressed latent cache
``{"c_kv", "k_rope", "positions"}``) and cross-attention (no mask, no
RoPE) always take ``_sdpa_chunked``, as in the JAX package. An MLA cache
has no per-row form, as there.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch import prng
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dtype_of, normal, rms_norm
from repro_torch.sharding.partition import merge_heads, on_local_shards, split_heads, write_slot

Q_CHUNK = 512
PER_ROW_MLA = "per-row decode: GQA caches only"


def _bias(y, p, name):
    return y + p[name] if name in p else y


def _maybe_lora(w, lora, name):
    if lora is None or f"a_{name}" not in lora:
        return w
    return w + lora[f"a_{name}"] @ lora[f"b_{name}"]


def init_attention(key, cfg, cross=False):
    """GQA projection params; key (..., 2) -> leaves with leading axes.
    ``cross=True`` (whisper's attentions) adds the zero biases."""
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
    if cfg.qkv_bias or cross:
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
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(_bias(x @ _maybe_lora(p["wq"], lora, "q"), p, "bq"), H, hd)
    k = split_heads(_bias(x @ _maybe_lora(p["wk"], lora, "k"), p, "bk"), KV, hd)
    v = split_heads(_bias(x @ _maybe_lora(p["wv"], lora, "v"), p, "bv"), KV, hd)
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


def _follow_heads(q, t):
    """K or V (B, S, KV, hd) of DTensor ``q`` (B, S, H, hd) whose heads are
    split where t's are not (KV does not divide the axis, H does: qwen3's
    8 kv heads on a 16-way model axis): each kv head repeated for its
    H // KV query heads and split as q is (a local slice), so each rank
    attends its own heads. Otherwise t as it is."""
    if not isinstance(q, DTensor) or not isinstance(t, DTensor) or t.shape[2] == q.shape[2]:
        return t
    on = [j for j, p in enumerate(q.placements) if p == Shard(2)]
    if not on or any(isinstance(t.placements[j], Shard) for j in on):
        return t
    B, S, KV, hd = t.shape
    t = t[:, :, :, None, :].expand(B, S, KV, q.shape[2] // KV, hd).reshape(B, S, -1, hd)
    return t.redistribute(t.device_mesh, [Shard(2) if j in on else p
                                          for j, p in enumerate(t.placements)])


def attend(q, k, v, q_pos, k_pos, scale, causal=True, window=0):
    """``_sdpa_chunked``; on DTensors on the local shards, whole along the
    sequence and the head dim (the positions whole), K and V following
    q's head split (``_follow_heads``)."""
    k, v = _follow_heads(q, k), _follow_heads(q, v)
    return on_local_shards(_sdpa_chunked, (q, k, v, q_pos, k_pos),
                           ((1, 3), (1, 3), (1, 3), (0,), (-1,)), scale=scale,
                           causal=causal, window=window)


def _train_attention(q, k, v, pos, scale, flash: bool):
    """Causal attention of a training forward, (B, S, H, hd) in and out:
    the ``flash_attention`` kernel (on (B, H, S, hd) views) or the chunked
    softmax."""
    if flash:
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               causal=True).transpose(1, 2)
    return _sdpa_chunked(q, k, v, pos, pos, scale, causal=True, window=0)


def attn_train(p, cfg, x, positions, lora=None):
    q, k, v = _project_qkv(p, cfg, x, lora)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    kw = dict(pos=positions[0], scale=cfg.hd ** -0.5, flash=cfg.use_pallas and S % 128 == 0)
    # on DTensors on the local shards, whole along the sequence and the head dim
    k, v = _follow_heads(q, k), _follow_heads(q, v)
    o = on_local_shards(_train_attention, (q, k, v), ((1, 3),) * 3, **kw)
    return _bias(merge_heads(o) @ p["wo"], p, "bo")


def attn_prefill(p, cfg, x, positions, lora=None):
    q, k, v = _project_qkv(p, cfg, x, lora)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, positions[0], positions[0], cfg.hd ** -0.5)
    y = _bias(merge_heads(o) @ p["wo"], p, "bo")
    return y, {"k": k, "v": v, "positions": positions[0]}


def init_cache(cfg, batch, length, dtype, device, per_row=False):
    """An empty cache of ``length`` slots (positions -1 = empty); with
    ``per_row`` the positions are (batch, length), one row per batch row."""
    shape = (batch, length, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "positions": torch.full((batch, length) if per_row else (length,), -1,
                                dtype=torch.int32, device=device),
    }


def _sdpa_decode_perrow(q, k, v, q_pos, k_pos, scale, window=0):
    """Per-row decode attention: q (B, 1, H, hd), k/v (B, W, KV, hd), q_pos
    (B,), k_pos (B, W). f32 scores and PV sums; slot j of row b is kept
    where 0 <= k_pos[b, j] <= q_pos[b] (and inside the window), else its
    score is -1e30; the probabilities are rounded to v's dtype."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qr = q.reshape(B, 1, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qr.to(torch.float32), k.to(torch.float32)) * scale
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        mask = mask & (k_pos > q_pos[:, None] - window)
    s = s.masked_fill(~mask[:, None, None, None, :], -1e30)
    p_attn = torch.softmax(s, dim=-1).to(v.dtype).to(torch.float32)
    o = torch.einsum("bkgqs,bskh->bqkgh", p_attn, v.to(torch.float32))
    return o.to(q.dtype).reshape(B, 1, H, v.shape[-1])


def attn_decode(p, cfg, x, pos, cache, lora=None):
    """x: (B, 1, d); pos: the absolute position (int) shared by every row,
    or a (B,) int tensor of each row's own for a per-row cache. Writes slot
    ``pos % W`` (of each row) of ``cache`` in place and returns it."""
    B = x.shape[0]
    W = cache["k"].shape[1]
    q, k, v = _project_qkv(p, cfg, x, lora)
    if cache["positions"].ndim == 2:
        # per row: the slots are written by index on the device, no host read
        posv = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(B, 1)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
        slots = (posv[:, 0] % W).long()
        cache["k"][rows, slots] = k[:, 0]
        cache["v"][rows, slots] = v[:, 0]
        cache["positions"][rows, slots] = posv[:, 0]
        o = _sdpa_decode_perrow(q, cache["k"], cache["v"], posv[:, 0], cache["positions"],
                                cfg.hd ** -0.5, window=cfg.sliding_window)
        return _bias(o.reshape(B, 1, -1) @ p["wo"], p, "bo"), cache
    pos = int(pos)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    slot = pos % W
    write_slot(cache["k"], 1, slot, k[:, 0])
    write_slot(cache["v"], 1, slot, v[:, 0])
    write_slot(cache["positions"], 0, slot, pos)   # a fill kernel: no host copy
    o = attend(q, cache["k"], cache["v"], posv[0], cache["positions"], cfg.hd ** -0.5,
               causal=True, window=cfg.sliding_window)
    return _bias(merge_heads(o) @ p["wo"], p, "bo"), cache


# ---------------------------------------------------------------- cross-attn

def cross_kv(p, cfg, enc):
    """Encoder K/V, once per sequence (whisper serving)."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = split_heads(_bias(enc @ p["wk"], p, "bk"), KV, hd)
    v = split_heads(_bias(enc @ p["wv"], p, "bv"), KV, hd)
    return k, v


def cross_attn(p, cfg, x, kv):
    """No mask, no RoPE: the decoder attends to every encoder frame."""
    S = x.shape[1]
    H, hd = cfg.n_heads, cfg.hd
    k, v = kv
    q = split_heads(_bias(x @ p["wq"], p, "bq"), H, hd)
    q_pos = torch.zeros(S, dtype=torch.int32, device=x.device)
    k_pos = torch.zeros(k.shape[1], dtype=torch.int32, device=x.device)
    o = attend(q, k, v, q_pos, k_pos, hd ** -0.5, causal=False)
    return _bias(merge_heads(o) @ p["wo"], p, "bo")


# ======================================================================= MLA

def init_mla(key, cfg):
    """DeepSeek-V2 Multi-head Latent Attention (no q compression: V2-Lite);
    key (..., 2) -> leaves with leading axes."""
    dt = dtype_of(cfg)
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    ks = prng.split(key, 4)
    std = d ** -0.5
    return {
        "wq": normal(ks[..., 0, :], (d, H * (dn + dr)), std, dt),
        "wkv_a": normal(ks[..., 1, :], (d, r + dr), std, dt),
        "kv_norm": torch.ones(*key.shape[:-1], r, dtype=dt, device=key.device),
        "wkv_b": normal(ks[..., 2, :], (r, H * (dn + dv)), r ** -0.5, dt),
        "wo": normal(ks[..., 3, :], (H * dv, d), (H * dv) ** -0.5, dt),
    }


def _mla_q(p, cfg, x, positions):
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = split_heads(x @ p["wq"], cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_compress(p, cfg, x, positions):
    """The latent ``c_kv`` (B, S, r), normed, and the shared RoPE key (B, S, dr)."""
    r = cfg.kv_lora_rank
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    return c_kv, apply_rope(kv_a[..., r:], positions, cfg.rope_theta)


def _mla_expand(p, cfg, c_kv):
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = split_heads(c_kv @ p["wkv_b"], cfg.n_heads, dn + dv)
    return kv[..., :dn], kv[..., dn:]                      # k_nope, v


def _mla_sdpa(cfg, qn, qr, kn, kr, v, q_pos, k_pos, window=0):
    """Scores qn.kn + qr.kr (kr shared across heads), scale (dn + dr)^-0.5.
    On DTensors on the local shards, the heads kept split where they are
    (kr read whole by every head)."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    return on_local_shards(_mla_scores, (qn, qr, kn, kr, v, q_pos, k_pos),
                           ((1, 3), (1, 3), (1, 3), (1, 2), (1, 3), (0,), (-1,)),
                           shared=(3,), scale=scale, window=window)


def _mla_scores(qn, qr, kn, kr, v, q_pos, k_pos, scale, window=0):
    q = torch.cat([qn, qr], dim=-1)
    kr_b = kr[:, :, None, :].expand(*kn.shape[:3], kr.shape[-1])
    k = torch.cat([kn, kr_b], dim=-1)
    return _sdpa_chunked(q, k, v, q_pos, k_pos, scale, causal=True, window=window)


def mla_train(p, cfg, x, positions):
    qn, qr = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_compress(p, cfg, x, positions)
    kn, v = _mla_expand(p, cfg, c_kv)
    o = _mla_sdpa(cfg, qn, qr, kn, k_rope, v, positions[0], positions[0])
    return merge_heads(o) @ p["wo"]


def mla_prefill(p, cfg, x, positions):
    qn, qr = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_compress(p, cfg, x, positions)
    kn, v = _mla_expand(p, cfg, c_kv)
    o = _mla_sdpa(cfg, qn, qr, kn, k_rope, v, positions[0], positions[0])
    cache = {"c_kv": c_kv, "k_rope": k_rope, "positions": positions[0]}
    return merge_heads(o) @ p["wo"], cache


def init_mla_cache(cfg, batch, length, dtype, device, per_row=False):
    """An empty compressed cache of ``length`` slots (positions -1 = empty);
    ``per_row`` is refused, as in the JAX package."""
    if per_row:
        raise NotImplementedError(PER_ROW_MLA)
    return {
        "c_kv": torch.zeros(batch, length, cfg.kv_lora_rank, dtype=dtype, device=device),
        "k_rope": torch.zeros(batch, length, cfg.qk_rope_head_dim, dtype=dtype, device=device),
        "positions": torch.full((length,), -1, dtype=torch.int32, device=device),
    }


def _einsum_f32(eq, *ops):
    """``jnp.einsum(..., preferred_element_type=f32)``: the operands cast up
    (exact) and the product in f32."""
    return torch.einsum(eq, *(o.to(torch.float32) for o in ops))


def mla_decode(p, cfg, x, pos, cache, absorb=False):
    """One token against the compressed cache; writes slot ``pos % W`` of
    ``cache`` in place and returns it.

    absorb=False: expand the whole cached latent through ``wkv_b`` each
    step. absorb=True: fold ``wkv_b`` into the query and output sides, so
    decode touches only the (r + dr)-wide latents; its four products in
    f32, each cast back as the JAX package casts it."""
    if cache["positions"].ndim == 2:
        raise NotImplementedError(PER_ROW_MLA)
    B = x.shape[0]
    W = cache["c_kv"].shape[1]
    pos = int(pos)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    qn, qr = _mla_q(p, cfg, x, posv)
    c_new, kr_new = _mla_compress(p, cfg, x, posv)
    slot = pos % W
    write_slot(cache["c_kv"], 1, slot, c_new[:, 0])
    write_slot(cache["k_rope"], 1, slot, kr_new[:, 0])
    write_slot(cache["positions"], 0, slot, pos)   # a fill kernel: no host copy
    c_kv, k_rope, cpos = cache["c_kv"], cache["k_rope"], cache["positions"]
    H, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    if not absorb:
        kn, v = _mla_expand(p, cfg, c_kv)
        o = _mla_sdpa(cfg, qn, qr, kn, k_rope, v, posv[0], cpos, window=cfg.sliding_window)
    else:
        scale = (dn + cfg.qk_rope_head_dim) ** -0.5
        wkv_b = split_heads(p["wkv_b"], H, dn + dv)
        w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]      # (r, H, dn), (r, H, dv)
        q_lat = _einsum_f32("bqhd,rhd->bqhr", qn, w_uk).to(qn.dtype)
        s = (_einsum_f32("bqhr,bsr->bhqs", q_lat, c_kv)
             + _einsum_f32("bqhd,bsd->bhqs", qr, k_rope)) * scale
        mask = (cpos >= 0) & (cpos <= pos)
        if cfg.sliding_window:
            mask = mask & (cpos > pos - cfg.sliding_window)
        s = s.masked_fill(~mask, -1e30)
        pa = torch.softmax(s, dim=-1).to(c_kv.dtype)
        o_lat = _einsum_f32("bhqs,bsr->bqhr", pa, c_kv).to(c_kv.dtype)
        o = _einsum_f32("bqhr,rhd->bqhd", o_lat, w_uv).to(x.dtype)
    return merge_heads(o) @ p["wo"], cache
