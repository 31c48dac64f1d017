"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, strictly sequential), as the JAX package defines them.

mLSTM is the decay-gated linear-attention form on the chunked SSD core of
``ssm.py`` (``ssd_chunked``, ``ssd_step``) with one group per head (G = H,
Hg = 1): log-decay a_t = logsigmoid(f_t), keys b = k, queries c = q, values
x = sigmoid(i_t) * v with an all-ones channel appended to v that carries
the normaliser; the output is num / max(|den|, 1e-3). As in the JAX
package it runs the plain ``ssd_chunked``, not the ``ssd_scan`` kernel
(whose P <= 128 cannot hold P = dk + 1), and its output gate is the
unfused ``rms_norm(out * silu(z))``, whose norm is the ``rmsnorm`` kernel
on a CUDA tensor.

sLSTM follows the stabilised equations (the running max m_t) with
per-head block-diagonal recurrent matrices. Where the JAX package
``lax.scan``s over time, the port loops in Python; the gates are f32 and
h goes back to the param dtype at every step. Decode writes its cache or
state in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.layers import dtype_of, normal, rms_norm
from repro_torch.models.ssm import _causal_conv, _softplus, ssd_chunked, ssd_step
from repro_torch.sharding.partition import merge_heads, on_local_shards, split_heads
from repro_torch.trips import scan

F32 = torch.float32


def _mdims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    return d_inner, H, d_inner // H


# ================================================================== mLSTM

def init_mlstm(key, cfg):
    """mLSTM params; key (..., 2) -> leaves with those leading axes."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    d_inner, H, dk = _mdims(cfg)
    lead, dev = tuple(key.shape[:-1]), key.device
    ks = prng.split(key, 6)
    bif = torch.cat([torch.zeros(H), torch.full((H,), 3.0)]).to(dt).to(dev)   # forget bias > 0
    return {
        "up": normal(ks[..., 0, :], (d, 2 * d_inner), d ** -0.5, dt),      # [xm, z]
        "conv_w": normal(ks[..., 1, :], (cfg.ssm_conv, d_inner), 0.1, dt),
        "conv_b": torch.zeros(*lead, d_inner, dtype=dt, device=dev),
        "wq": normal(ks[..., 2, :], (d_inner, d_inner), d_inner ** -0.5, dt),
        "wk": normal(ks[..., 3, :], (d_inner, d_inner), d_inner ** -0.5, dt),
        "wif": normal(ks[..., 4, :], (d_inner, 2 * H), d_inner ** -0.5, dt),
        "bif": bif.expand(*lead, 2 * H).clone(),
        "gate_norm": torch.ones(*lead, d_inner, dtype=dt, device=dev),
        "down": normal(ks[..., 5, :], (d_inner, d), d_inner ** -0.5, dt),
    }


def _mlstm_qkviaf(p, cfg, xm):
    """xm: (B, L, d_inner) after the conv; returns q, k (B, L, H, dk), the
    values with the normaliser channel (B, L, H, dk + 1) and the log
    forget gate (B, L, H) f32."""
    _, H, dk = _mdims(cfg)
    q = split_heads(xm @ p["wq"], H, dk)
    k = split_heads(xm @ p["wk"], H, dk) * dk ** -0.5
    v = split_heads(xm, H, dk)
    gif = (xm @ p["wif"] + p["bif"]).to(F32)
    ig = torch.sigmoid(gif[..., :H])[..., None].to(v.dtype)    # (B, L, H, 1)
    a = -_softplus(-gif[..., H:])                              # jax.nn.log_sigmoid
    xv = torch.cat([v * ig, torch.ones_like(ig) * ig], dim=-1)
    return q, k, xv, a


def _mlstm_out(p, cfg, y, z):
    dk = _mdims(cfg)[2]
    num, den = y[..., :dk], y[..., dk:]
    out = merge_heads(num / torch.clamp(den.abs(), min=1e-3))
    out = rms_norm(out * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return out @ p["down"]


def mlstm_forward(p, cfg, u, return_state=False):
    """u: (B, L, d). With ``return_state`` also the decode cache
    ``{"state": (B, H, 1, dk, dk + 1) f32, "conv": the last ssm_conv conv
    inputs}``."""
    L = u.shape[1]
    d_inner = _mdims(cfg)[0]
    up = u @ p["up"]
    xm_raw, z = up[..., :d_inner], up[..., d_inner:]
    xm = F.silu(_causal_conv(xm_raw, p["conv_w"], p["conv_b"]))
    q, k, xv, a = _mlstm_qkviaf(p, cfg, xm)
    # group axis g = H (per-head keys and queries), one head per group
    y, h_fin = ssd_chunked(xv[:, :, :, None, :], a[:, :, :, None], k, q, cfg.ssm_chunk,
                           checkpoint_chunks=cfg.ssm_checkpoint_chunks)
    out = _mlstm_out(p, cfg, y[:, :, :, 0, :], z)
    if not return_state:
        return out
    kk = cfg.ssm_conv
    # the last kk conv inputs, zeros ahead where L < kk; a copy, so the
    # cache does not hold the whole up-projection alive
    tail = xm_raw[:, L - kk:].clone() if L >= kk else F.pad(xm_raw, (0, 0, kk - L, 0))
    return out, {"state": h_fin, "conv": tail}


def init_mlstm_cache(cfg, batch, dtype, device):
    d_inner, H, dk = _mdims(cfg)
    return {
        "state": torch.zeros(batch, H, 1, dk, dk + 1, dtype=F32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv, d_inner, dtype=dtype, device=device),
    }


def mlstm_decode(p, cfg, u1, cache):
    """u1: (B, 1, d); O(1) state update, written into ``cache`` in place."""
    d_inner = _mdims(cfg)[0]
    up = u1 @ p["up"]
    xm_raw, z = up[..., :d_inner], up[..., d_inner:]
    conv = torch.cat([cache["conv"][:, 1:, :], xm_raw], dim=1)
    xm = F.silu(torch.einsum("bkc,kc->bc", conv, p["conv_w"]) + p["conv_b"])[:, None, :]
    q, k, xv, a = _mlstm_qkviaf(p, cfg, xm)
    h, y = ssd_step(cache["state"], xv[:, 0, :, None, :], a[:, 0, :, None], k[:, 0], q[:, 0])
    out = _mlstm_out(p, cfg, y[:, None, :, 0, :], z)
    cache["state"].copy_(h)
    cache["conv"].copy_(conv)
    return out, cache


# ================================================================== sLSTM

def init_slstm(key, cfg):
    """sLSTM params; key (..., 2) -> leaves with those leading axes.
    ``ff_gate`` and ``ff_up`` are drawn from one key, as in the JAX
    package, so the two are equal."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    lead, dev = tuple(key.shape[:-1]), key.device
    ks = prng.split(key, 4)
    ffd = int(d * 4 / 3)
    b = torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0), torch.zeros(d)]).to(dt).to(dev)
    return {
        "wx": normal(ks[..., 0, :], (d, 4 * d), d ** -0.5, dt),          # z, i, f, o
        "r": normal(ks[..., 1, :], (4, H, dh, dh), dh ** -0.5, dt),
        "b": b.expand(*lead, 4 * d).clone(),
        "out_norm": torch.ones(*lead, d, dtype=dt, device=dev),
        "ff_gate": normal(ks[..., 2, :], (d, ffd), d ** -0.5, dt),
        "ff_up": normal(ks[..., 2, :], (d, ffd), d ** -0.5, dt),
        "ff_down": normal(ks[..., 3, :], (ffd, d), ffd ** -0.5, dt),
    }


def _recurrent(p, cfg):
    """The recurrent matrices r (4, H, dh, dh) as one (H, dh, 4 dh) operand
    of a batched matmul, arranged once per sequence: a per-step einsum
    would copy r at every step, and autograd would keep every copy."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    return p["r"].permute(1, 2, 0, 3).reshape(H, dh, 4 * dh)


def _slstm_cell(b, cfg, wx_t, st, r):
    """One time step. b: the bias (4d,); wx_t: (B, 4d), the input part; st:
    the state dict; r: ``_recurrent(p, cfg)``. Returns (new state, h (B, d)
    in the param dtype)."""
    d = cfg.d_model
    H = cfg.n_heads
    B = wx_t.shape[0]
    h = st["h"]
    # the JAX package's einsum("bhd,ghde->gbhe", h, r), as (H, B, 4 dh)
    rec = torch.bmm(h.reshape(B, H, d // H).transpose(0, 1), r)
    rec = rec.reshape(H, B, 4, d // H).permute(2, 1, 0, 3).reshape(4, B, d)
    pre = wx_t.reshape(B, 4, d).transpose(0, 1) + rec + b.reshape(4, d)[:, None, :]
    zt = torch.tanh(pre[0].to(F32))
    it = pre[1].to(F32)
    ft = pre[2].to(F32)
    ot = torch.sigmoid(pre[3].to(F32))
    m_new = torch.maximum(ft + st["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + st["m"] - m_new)
    c = f_p * st["c"] + i_p * zt
    n = f_p * st["n"] + i_p
    h_new = (ot * c / torch.clamp(n.abs(), min=1e-3)).to(h.dtype)
    return {"h": h_new, "c": c, "n": n, "m": m_new}, h_new


STATE = ("h", "c", "n", "m")


def init_slstm_state(cfg, batch, dtype, device):
    d = cfg.d_model
    return {"h": torch.zeros(batch, d, dtype=dtype, device=device),
            "c": torch.zeros(batch, d, dtype=F32, device=device),
            "n": torch.zeros(batch, d, dtype=F32, device=device),
            "m": torch.zeros(batch, d, dtype=F32, device=device)}


def _slstm_ffn(p, cfg, y):
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return (F.silu(y @ p["ff_gate"]) * (y @ p["ff_up"])) @ p["ff_down"]


def _slstm_steps(wx, r, b, *state, cfg):
    """The cell over every position of wx (B, L, 4d) from the state (h, c,
    n, m), zeros where none is given. Returns (h of every step (B, L, d),
    then the last state's h, c, n, m)."""
    if not state:
        st = init_slstm_state(cfg, wx.shape[0], wx.dtype, wx.device)
        state = tuple(st[k] for k in STATE)

    def cell(w, r_, b_, *s):
        new, _ = _slstm_cell(b_, cfg, w, dict(zip(STATE, s)), r_)
        return tuple(new[k] for k in STATE)

    hs, last = scan(cell, wx, (r, b), state)
    return (hs, *last)


def _slstm_run(p, cfg, u, st=None):
    """``_slstm_steps`` on u (B, L, d) from the state ``st`` (zeros for
    None); on DTensors on the local shards, split by batch only (a step of
    the loop over time has too little work for DTensor's per-op cost, and
    a head's gates mix its whole width)."""
    args = (u @ p["wx"], _recurrent(p, cfg), p["b"]) + (
        () if st is None else tuple(st[k] for k in STATE))
    out = on_local_shards(_slstm_steps, args,
                          ((1, 2), (0, 1, 2), (0,)) + ((1,),) * (len(args) - 3), cfg=cfg)
    return out[0], dict(zip(STATE, out[1:]))


def slstm_forward(p, cfg, u, state=None, return_state=False):
    """u: (B, L, d), one cell step per position. With ``return_state`` also
    the state after the last step."""
    hs, st = _slstm_run(p, cfg, u, state)
    y = _slstm_ffn(p, cfg, hs)
    if return_state:
        return y, st
    return y


def slstm_decode(p, cfg, u1, state):
    """u1: (B, 1, d); one cell step, the state written in place."""
    hs, st = _slstm_run(p, cfg, u1, state)
    for name, t in st.items():
        state[name].copy_(t)
    return _slstm_ffn(p, cfg, hs), state
