"""Shared building blocks of the LMs: norms (RMSNorm and whisper's
LayerNorm), the SwiGLU and GELU MLPs, RoPE, sinusoidal positions,
embeddings.

Parameters are plain nested dicts of tensors with the JAX package's keys
and shapes. ``init_*`` draw from ``repro_torch.prng`` exactly as the JAX
package draws from ``jax.random``, so a model initialised from the same
key is the same model (within ``prng.normal``'s 4.8e-7). Where the JAX
package ``vmap``s a per-layer init over ``split(key, n)``, the port calls
the init once with the (n, 2) batch of keys: every ``init_*`` takes keys
with leading axes and returns leaves with those axes in front.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import prng
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_trainable
from repro_torch.sharding.partition import gather_seq, on_local_shards


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(key, shape, std, dtype):
    """``std * N(0, 1)`` drawn in f32, cast to ``dtype``; key (..., 2) ->
    (..., *shape). Scaled in place: a stacked leaf of a deep model is the
    largest tensor of its init."""
    return prng.normal(key, shape).mul_(std).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    """Row-wise RMSNorm over the last axis: the ``rmsnorm`` kernel on a CUDA
    tensor, its plain version on a CPU one. Where autograd records the
    call (training), through ``rmsnorm_trainable``: the same forward and a
    plain analytic backward. DTensors go to it as their local shards, with
    the last axis whole (``sharding.partition.on_local_shards``), and the
    result has its sequence whole (``gather_seq``): a norm's output feeds
    the projections."""
    return gather_seq(on_local_shards(_rms_norm, (x, scale), ((-1,), (0,)), eps=eps))


def _rms_norm(x, scale, eps=1e-6):
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return rmsnorm_trainable(x, scale, eps)
    return rmsnorm(x, scale, eps)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis in f32, with the two-pass variance the
    JAX package takes (``jnp.var``); no kernel on either side. On a DTensor
    the result has its sequence whole, as ``rms_norm``'s."""
    x32 = x.to(torch.float32)
    centered = x32 - torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return gather_seq((y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype))


def linear(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


# ---------------------------------------------------------------- MLP

def init_swiglu(key, d_model, d_ff, dtype):
    ks = prng.split(key, 3)
    std = d_model ** -0.5
    return {
        "gate": normal(ks[..., 0, :], (d_model, d_ff), std, dtype),
        "up": normal(ks[..., 1, :], (d_model, d_ff), std, dtype),
        "down": normal(ks[..., 2, :], (d_ff, d_model), d_ff ** -0.5, dtype),
    }


def swiglu(p, x):
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def init_gelu_mlp(key, d_model, d_ff, dtype):
    ks = prng.split(key, 2)
    lead = tuple(key.shape[:-1])
    return {
        "fc1": normal(ks[..., 0, :], (d_model, d_ff), d_model ** -0.5, dtype),
        "b1": torch.zeros(*lead, d_ff, dtype=dtype, device=key.device),
        "fc2": normal(ks[..., 1, :], (d_ff, d_model), d_ff ** -0.5, dtype),
        "b2": torch.zeros(*lead, d_model, dtype=dtype, device=key.device),
    }


def gelu_mlp(p, x):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    return linear(F.gelu(linear(x, p["fc1"], p["b1"]), approximate="tanh"), p["fc2"], p["b2"])


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim, theta):
    """In numpy f32, as the JAX package computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, theta, device):
    # one upload per (head_dim, theta, device): a copy from host memory per
    # call would make the host wait for the card at every layer
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    if x.ndim == ang.ndim + 1:                            # has a heads axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos, d_model, device="cpu"):
    """The (n_pos, d_model) sinusoid table, built in float64 numpy and cast
    to f32, as the JAX package builds it."""
    return _sinusoid_on(n_pos, d_model, torch.device(device))


@functools.lru_cache(maxsize=None)
def _sinusoid_on(n_pos, d_model, device):
    # one upload per (n_pos, d_model, device), as for the RoPE frequencies
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d_model)[None, :]
    ang = pos / np.power(10_000, 2 * (dim // 2) / d_model)
    enc = np.where(dim % 2 == 0, np.sin(ang), np.cos(ang))
    return torch.from_numpy(enc.astype(np.float32)).to(device)


# ---------------------------------------------------------------- embedding

def init_embedding(key, vocab, d_model, dtype):
    return {"tok": normal(key, (vocab, d_model), 0.02, dtype)}


def _lookup(tokens, table):
    return table[tokens]


def embed(p, tokens):
    # on DTensors on the local shards: the tokens keep their batch split,
    # the table is gathered whole (its gradient a pending sum over the
    # split); DTensor's own gather and embedding rules for a sharded
    # index do not run on every torch this targets
    return on_local_shards(_lookup, (tokens, p["tok"]), ((), (0, 1)))


def unembed(p, x, head=None):
    return x @ (head if head is not None else p["tok"].T)


def stacked_init(init_fn, key, n):
    """``init_fn`` over ``split(key, n)`` -> params with a leading layer axis."""
    return init_fn(prng.split(key, n))


def _vocab_ids(logits):
    """0..V-1 as a DTensor split as the last dim of ``logits`` is, each
    rank making its own part: compared with the labels it gives a hit mask
    laid out as the logits, so the masked sum moves no logit."""
    last = logits.ndim - 1
    pl = [Shard(0) if p == Shard(last) else Replicate() for p in logits.placements]
    return distribute_tensor(torch.arange(logits.shape[-1], device=logits.device),
                             logits.device_mesh, pl, src_data_rank=None)


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits (..., V) cast to f32, labels int."""
    logits = logits.to(torch.float32)
    if isinstance(logits, DTensor):
        # logsumexp as a max and a sum over the vocab, each reduced across
        # its shards (DTensor's own logsumexp gathers the whole vocab); the
        # gold logit as a masked sum, likewise (a gather along a sharded
        # axis does not run), exact, as every other term is 0
        m = logits.detach().amax(dim=-1, keepdim=True)
        logz = (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)))[..., 0]
        hit = _vocab_ids(logits) == labels.long()[..., None]
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
