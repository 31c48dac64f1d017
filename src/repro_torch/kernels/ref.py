"""Plain PyTorch versions of the port's kernels (the correctness oracles).

Each ``ref_*`` computes its kernel's contract with ordinary tensor ops.
The CPU path of each wrapper and the tests use them; ``chip_smoke.py``
holds every kernel against them on the card. The CUDA path never calls
them.
"""

from __future__ import annotations

import torch


def ref_fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (K, N); weights: (K,) -> (N,), summed in f32 and cast
    back to ``stacked``'s dtype."""
    return torch.tensordot(weights.to(torch.float32), stacked.to(torch.float32),
                           dims=([0], [0])).to(stacked.dtype)


def ref_fused_aggregate(stacked, weights, staleness, m, v, *, mode, beta,
                        normalizer, lr=1.0, beta1=0.9, beta2=0.99, eps=1e-3):
    """Plain version of ``fused_aggregate``: the FedAST staleness discount
    (normalised by the UNDISCOUNTED weight sum the caller passes as
    ``normalizer``), the weighted reduce, and the FedOpt moment update,
    all in f32. Returns ``(update, new_m, new_v)``; a mode that leaves a
    moment unchanged returns the (f32) input itself."""
    f32 = torch.float32
    w = torch.as_tensor(weights).to(f32)
    st = torch.as_tensor(staleness).to(device=w.device, dtype=f32)
    norm = torch.as_tensor(normalizer).to(device=w.device, dtype=f32)
    disc = w * (1.0 + st) ** (-beta) / torch.clamp(norm, min=1e-12)
    d = torch.tensordot(disc, torch.as_tensor(stacked).to(f32), dims=([0], [0]))
    m = torch.as_tensor(m).to(f32)
    v = torch.as_tensor(v).to(f32)
    if mode == "fedavg":
        return lr * d, m, v
    if mode == "fedavgm":
        m = beta1 * m + d
        return lr * m, m, v
    m = beta1 * m + (1.0 - beta1) * d
    d2 = d * d
    if mode == "fedadam":
        v = beta2 * v + (1.0 - beta2) * d2
    elif mode == "fedyogi":
        v = v - (1.0 - beta2) * d2 * torch.sign(v - d2)
    else:
        raise ValueError(f"ref_fused_aggregate: unknown mode {mode!r}")
    return lr * m / (torch.sqrt(v) + eps), m, v


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Plain version of ``flash_attention``: q (B, H, Sq, hd), k and v
    (B, KV, Sk, hd) -> (B, H, Sq, hd) in q's dtype. Softmax attention in
    f32, scale hd^-0.5, head h reading kv head h // (H // KV); causal is
    top-left aligned (query i sees keys j <= i), masked scores -1e30."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    kf = k.repeat_interleave(G, dim=1).to(torch.float32)
    vf = v.repeat_interleave(G, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) * hd ** -0.5
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ref_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of ``rmsnorm``: ``x * rsqrt(mean(x^2) + eps) * w`` per
    row of the last axis, in f32 (f64 for f64 x), cast back to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.to(acc)).to(x.dtype)


def ref_rmsnorm_backward(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                         eps: float = 1e-6):
    """The analytic gradient of ``ref_rmsnorm`` at (x, w) for the output
    gradient ``g``, in f32 with ``rstd`` recomputed from x:
    ``dx = rstd*(g*w) - x*rstd^3*mean(g*w*x)`` per row and
    ``dw = sum over rows of g*x*rstd`` (f64 for f64 x, as the forward).
    Returns (dx in x's dtype, dw in w's dtype)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32, g32, w32 = x.to(acc), g.to(acc), w.to(acc)
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gw = g32 * w32
    dx = rstd * gw - x32 * rstd.pow(3) * (gw * x32).mean(dim=-1, keepdim=True)
    dw = (g32 * x32 * rstd).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def ref_gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version of ``gated_rmsnorm`` (Mamba2's output gate): in f32,
    ``g = x * silu(z)``, then ``g * rsqrt(mean(g^2) + eps) * w`` per row of
    the last axis, cast back to x's dtype."""
    z32 = z.to(torch.float32)
    g = x.to(torch.float32) * (z32 * torch.sigmoid(z32))
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def ref_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            return_state: bool = False):
    """Plain version of ``ssd_scan``: the sequential SSD recurrence in f32.
    x: (B, H, L, P); a: (B, H, L) log-decay; b, c: (B, H, L, N).

        h_t = exp(a_t) h_{t-1} + b_t^T x_t ;  y_t = c_t h_t,  h_0 = 0.

    Returns y in x's dtype, and with ``return_state`` also the final state
    h_L, (B, H, N, P) f32."""
    B, H, L, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    xf, af, bf, cf = (t.to(f32) for t in (x, a, b, c))
    h = torch.zeros(B, H, N, P, dtype=f32, device=x.device)
    ys = []
    for t in range(L):
        h = (h * torch.exp(af[:, :, t])[..., None, None]
             + bf[:, :, t, :, None] * xf[:, :, t, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, :, t], h))
    y = (torch.stack(ys, dim=2) if ys else xf.new_zeros(B, H, 0, P)).to(x.dtype)
    return (y, h) if return_state else y
