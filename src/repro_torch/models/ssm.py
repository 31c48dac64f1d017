"""State-space sequence mixing: the chunked SSD core and the Mamba2 block.

The SSD (state-space dual) recurrence
    h_t = exp(a_t) * h_{t-1} + b_t (x)  (outer product b_t xtilde_t)
    y_t = <c_t, h_t>
is shared by Mamba2 (a = dt*A, b/c shared across heads, x folded with dt)
and mLSTM (a = log sigmoid(forget), b=k, c=q), so ``ssd_chunked`` keeps
the JAX package's group axis G: Mamba2 uses G=1 (B/C broadcast over
heads), mLSTM G=H. Chunks go in a Python loop carrying the inter-chunk
state, where the JAX package runs a checkpointed ``lax.scan``.

``mamba2_forward`` (train and prefill) follows the JAX package op for op.
Under ``cfg.use_pallas`` its scan (no initial state, one group) goes to
the ``ssd_scan`` kernel and its output gate to the ``gated_rmsnorm``
kernel, as the JAX package sends the gate to ``gated_rmsnorm_pallas``;
otherwise it runs ``ssd_chunked`` and ``rms_norm(y * silu(z))``, whose
norm is the ``rmsnorm`` kernel on a CUDA tensor. ``mamba2_decode`` keeps
``ssd_step`` and ``rms_norm(y * silu(z))``, as the JAX package does, and
writes its cache in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch.kernels.gated_rmsnorm import gated_rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import dtype_of, normal, rms_norm
from repro_torch.sharding.partition import on_local_shards

F32 = torch.float32


def segsum(a):
    """(..., c) -> (..., c, c); out[i,j] = sum_{j<k<=i} a_k, -inf above diag."""
    c = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, a, b, c, chunk, h0=None, checkpoint_chunks=True):
    """x:(B,L,G,Hg,P) values; a:(B,L,G,Hg) log-decay (<=0); b,c:(B,L,G,N).

    On DTensors the scan runs on the local shards, whole along L and the
    state dims (``on_local_shards``): split by batch, and by groups or by
    heads where the inputs are (one group's b and c are shared by the
    heads).

    Returns y:(B,L,G,Hg,P) and final state (B,G,Hg,N,P) f32. Decays in f32
    (exp of cumsums), products in f32 with the decay matrices rounded to
    x's dtype first, as the JAX package computes them. Where autograd
    records the call and ``checkpoint_chunks`` is set, each chunk runs
    under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint(step)``): the backward recomputes a chunk's
    intermediates instead of keeping them. It changes memory, not values.
    """
    tensors = (x, a, b, c) + (() if h0 is None else (h0,))
    return on_local_shards(
        _ssd_chunked, tensors, ((1, 4), (1,), (1, 3), (1, 3), (3, 4)),
        shared=(2, 3) if b.shape[2] == 1 else (), chunk=chunk,
        checkpoint_chunks=checkpoint_chunks)


def _ssd_chunked(x, a, b, c, h0=None, *, chunk, checkpoint_chunks):
    B, L, G, Hg, P = x.shape
    N = b.shape[-1]
    chunk = min(chunk, L)
    Lp = -(-L // chunk) * chunk
    if Lp != L:
        # pad tail with identity steps: a=0 (decay 1), b=x=0 -> state kept
        x, a, b, c = (F.pad(t, [0, 0] * (t.ndim - 2) + [0, Lp - L]) for t in (x, a, b, c))
    dt = x.dtype
    h = torch.zeros(B, G, Hg, N, P, dtype=F32, device=x.device) if h0 is None else h0.to(F32)

    def step(h, xz, az, bz, cz):
        xz, bz, cz, az = (t.to(F32) for t in (xz, bz, cz, az))   # az: (B,c,G,Hg)
        acs = torch.cumsum(az, dim=1)
        Lm = torch.exp(segsum(az.permute(0, 2, 3, 1))).to(dt).to(F32)   # (B,G,Hg,c,c)
        scores = torch.einsum("bign,bjgn->bgij", cz, bz)[:, :, None] * Lm
        y_diag = torch.einsum("bghij,bjghp->bighp", scores, xz)
        decay_states = torch.exp(acs[:, -1:] - acs).to(dt).to(F32)
        new_contrib = torch.einsum("bjgh,bjgn,bjghp->bghnp", decay_states, bz, xz)
        y_off = torch.einsum("bign,bigh,bghnp->bighp", cz, torch.exp(acs).to(dt).to(F32),
                             h.to(dt).to(F32))
        h = h * torch.exp(acs[:, -1])[..., None, None] + new_contrib
        return h, (y_diag + y_off).to(dt)

    if checkpoint_chunks and _records_grad(x, a, b, c, h):
        def run(*args):
            return checkpoint(step, *args, use_reentrant=False)
    else:
        run = step
    ys = []
    for z0 in range(0, Lp, chunk):
        h, y = run(h, *(t[:, z0:z0 + chunk] for t in (x, a, b, c)))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y, h


def _records_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ssd_step(h, x1, a1, b1, c1):
    """Single-token recurrence. h:(B,G,Hg,N,P) x1:(B,G,Hg,P) a1:(B,G,Hg)
    b1,c1:(B,G,N). On DTensors on the local shards, as ``ssd_chunked``."""
    return on_local_shards(_ssd_step, (h, x1, a1, b1, c1), ((3, 4), (3,), (), (2,), (2,)),
                           shared=(3, 4) if b1.shape[1] == 1 else ())


def _ssd_step(h, x1, a1, b1, c1):
    h = (h * torch.exp(a1.to(F32))[..., None, None]
         + torch.einsum("bgn,bghp->bghnp", b1.to(F32), x1.to(F32)))
    y = torch.einsum("bgn,bghnp->bghp", c1.to(F32), h)
    return h, y.to(x1.dtype)


# ================================================================= Mamba2

def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def a_log_init(nheads: int) -> np.ndarray:
    """``log(linspace(1, 16, nheads))`` in f32, as the JAX package computes
    it. XLA folds ``jnp.linspace``'s f32 formula into ``(1 - i*c) + i*(16c)``
    with ``c = f32(1 / (n - 1))`` and fuses the last multiply-add; both are
    reproduced exactly here (the f64 product of two f32 values is exact).
    The log is XLA:CPU's f32 log (``prng._log_f32``), which is not always
    correctly rounded, so the result is bit-equal to the JAX package's."""
    f32 = np.float32
    if nheads <= 1:
        lin = np.ones(nheads, f32)
    else:
        i = np.arange(nheads - 1, dtype=f32)
        c = f32(1) / f32(nheads - 1)
        c16 = f32(16) * c
        one_minus = f32(1) - i * c
        head = (i.astype(np.float64) * np.float64(c16)
                + one_minus.astype(np.float64)).astype(f32)
        lin = np.append(head, f32(16))
    return prng._log_f32(torch.from_numpy(lin)).numpy()


def init_mamba2(key, cfg):
    """Mamba2 params; key (..., 2) -> leaves with those leading axes."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    d_inner, nheads, N = _dims(cfg)
    conv_ch = d_inner + 2 * N                     # conv over [x, B, C]
    lead, dev = tuple(key.shape[:-1]), key.device
    ks = prng.split(key, 4)
    proj_out = 2 * d_inner + 2 * N + nheads       # z, x, B, C, dt

    def fill(n, value):
        return torch.full((*lead, n), value, dtype=dt, device=dev)

    a_log = torch.from_numpy(a_log_init(nheads)).to(dt).to(dev)
    return {
        "in_proj": normal(ks[..., 0, :], (d, proj_out), d ** -0.5, dt),
        "conv_w": normal(ks[..., 1, :], (cfg.ssm_conv, conv_ch), 0.1, dt),
        "conv_b": fill(conv_ch, 0.0),
        "A_log": a_log.expand(*lead, nheads).clone(),
        "D": fill(nheads, 1.0),
        "dt_bias": fill(nheads, 0.0),
        "gate_norm": fill(d_inner, 1.0),
        "out_proj": normal(ks[..., 2, :], (d_inner, d), d_inner ** -0.5, dt),
    }


def _kernel_scan(x, a, b, c, *, chunk):
    """The ``ssd_scan`` kernel on (B, L, H, P) values, (B, L, H) log-decays
    and (B, L, N) b and c, in the kernel's (B, H, L, *) layout as views (b
    and c stride-0 head views, shared by the heads). Returns y (B, L, H, P)
    and the final state (B, H, N, P)."""
    B, L, H, _ = x.shape
    N = b.shape[-1]
    y, h = ssd_scan(x.transpose(1, 2), a.transpose(1, 2), b[:, None].expand(B, H, L, N),
                    c[:, None].expand(B, H, L, N), chunk, return_state=True)
    return y.transpose(1, 2), h


def _causal_conv(seq, w, b):
    """Depthwise causal conv. seq:(B,L,C), w:(k,C). On DTensors on the
    local shards, whole along L, w and b split as seq's channels are
    (torch 2.11's DTensor pads a split tensor wrongly)."""
    return on_local_shards(_conv_local, (seq, w[None], b[None, None]), ((1,), (1,), ()),
                           shared=(1, 2))


def _conv_local(seq, w, b):
    return _conv(seq, w[0], b[0, 0])


def _conv(seq, w, b):
    k = w.shape[0]
    pad = F.pad(seq, (0, 0, k - 1, 0))
    out = torch.zeros_like(seq)
    for i in range(k):
        out = out + pad[:, i:i + seq.shape[1], :] * w[i]
    return out + b


def _mamba2_inner(p, cfg, u):
    """Project and split; returns (z, xBC, dt) pieces (views of one product)."""
    d_inner, nheads, N = _dims(cfg)
    proj = u @ p["in_proj"]
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * N]
    dt_pre = proj[..., -nheads:]
    return z, xBC, dt_pre


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _decay(p, dt_pre):
    """(dt, A): softplus(dt_pre + dt_bias) and -exp(A_log), in f32."""
    dt = _softplus(dt_pre.to(F32) + p["dt_bias"].to(F32))
    return dt, -torch.exp(p["A_log"].to(F32))


def mamba2_forward(p, cfg, u, h0=None, return_state=False):
    """u: (B,L,d). Full-sequence (train/prefill) path. With ``return_state``
    also the decode cache ``{"state": (B,1,H,N,P) f32, "conv": the last
    ssm_conv inputs of the conv}``."""
    B, L, _ = u.shape
    d_inner, nheads, N = _dims(cfg)
    P = cfg.ssm_head_dim
    z, xBC_raw, dt_pre = _mamba2_inner(p, cfg, u)
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xh = xBC[..., :d_inner].reshape(B, L, 1, nheads, P)
    Bk = xBC[..., d_inner:d_inner + N]                          # (B,L,N)
    Cq = xBC[..., d_inner + N:]
    dt, A = _decay(p, dt_pre)                                   # (B,L,H)
    a = dt * A
    xdt = xh * dt[:, :, None, :, None].to(xh.dtype)             # (B,L,1,H,P)
    if cfg.use_pallas and h0 is None:
        # on DTensors whole along L and the state dims; B and C shared by the heads
        y, h_fin = on_local_shards(_kernel_scan, (xdt[:, :, 0], a, Bk, Cq),
                                   ((1, 3), (1,), (1, 2), (1, 2)), shared=(2, 3),
                                   chunk=cfg.ssm_chunk)
        h_fin = h_fin[:, None]
    else:
        y, h_fin = ssd_chunked(xdt, a[:, :, None], Bk[:, :, None], Cq[:, :, None],
                               cfg.ssm_chunk, h0, checkpoint_chunks=cfg.ssm_checkpoint_chunks)
    y = y.reshape(B, L, d_inner) + xBC[..., :d_inner] * torch.repeat_interleave(p["D"], P)
    if cfg.use_pallas:
        y = on_local_shards(gated_rmsnorm, (y, z, p["gate_norm"]), ((-1,), (-1,), (0,)),
                            eps=cfg.norm_eps)
    else:
        y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    k = cfg.ssm_conv
    # the last k conv inputs, zeros ahead where L < k; a copy, so the cache
    # does not hold the whole in-projection alive
    tail = xBC_raw[:, L - k:].clone() if L >= k else F.pad(xBC_raw, (0, 0, k - L, 0))
    return out, {"state": h_fin, "conv": tail}


def init_mamba2_cache(cfg, batch, dtype, device):
    d_inner, nheads, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "state": torch.zeros(batch, 1, nheads, N, cfg.ssm_head_dim, dtype=F32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv, conv_ch, dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, u1, cache):
    """u1: (B,1,d); O(1) state update, written into ``cache`` in place."""
    B = u1.shape[0]
    d_inner, nheads, N = _dims(cfg)
    z, xBC_new, dt_pre = _mamba2_inner(p, cfg, u1)
    conv = torch.cat([cache["conv"][:, 1:, :], xBC_new], dim=1)
    xBC = torch.einsum("bkc,kc->bc", conv, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(xBC)
    xh = xBC[:, :d_inner].reshape(B, 1, nheads, cfg.ssm_head_dim)
    Bk = xBC[:, None, d_inner:d_inner + N]                      # (B,1,N)
    Cq = xBC[:, None, d_inner + N:]
    dt, A = _decay(p, dt_pre[:, 0])                             # (B,H)
    a = (dt * A)[:, None, :]                                    # (B,1,H)
    xdt = xh * dt[:, None, :, None].to(xh.dtype)
    h, y = ssd_step(cache["state"], xdt, a, Bk, Cq)
    y = y.reshape(B, d_inner) + xBC[:, :d_inner] * torch.repeat_interleave(
        p["D"], cfg.ssm_head_dim)
    y = rms_norm(y * F.silu(z[:, 0]), p["gate_norm"], cfg.norm_eps)
    cache["state"].copy_(h)
    cache["conv"].copy_(conv)
    return (y @ p["out_proj"])[:, None, :], cache
