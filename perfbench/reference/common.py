"""Building blocks of the reference models: the configuration, the seeded
weight draws, norms, MLPs, RoPE, sinusoids, the embedding, the loss and
softmax attention.

Parameters are nested dicts of tensors, keyed and shaped as the port keys
and shapes them, so the benchmark can hand one set of weights to both.
The weights are drawn here, from a ``torch.Generator`` on the device: an
``init`` of a family walks the tree in a fixed order and draws each leaf
that is not a constant in one call (a stacked leaf holds every layer).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


@dataclass(frozen=True)
class ModelConfig:
    """The sizes of one model as the configuration file states them (the
    port's field names and defaults)."""

    name: str
    arch_type: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    moe_groups: int = 1
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0
    shared_attn_lora_rank: int = 0
    n_enc_layers: int = 0
    enc_frames: int = 1500
    n_img_tokens: int = 0
    param_dtype: str = "float32"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


# ----------------------------------------------------------------- weights

class Draw:
    """The seeded source of one model's weights. ``key(*lead)`` stands for
    a batch of init keys with leading axes ``lead``: a leaf drawn for it
    has those axes in front, as a stacked layer leaf has."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed % 2**63)

    def normal(self, lead, shape, std, dtype):
        t = torch.randn(*lead, *shape, generator=self.gen, device=self.device, dtype=F32)
        return t.mul_(std).to(dtype)

    def full(self, lead, n, value, dtype):
        return torch.full((*lead, n), value, dtype=dtype, device=self.device)


# ----------------------------------------------------------------- layers

def rms_norm(x, scale, eps):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32."""
    x32 = x.to(F32)
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.to(F32)).to(x.dtype)


def layer_norm(x, scale, bias, eps):
    """LayerNorm over the last axis in f32 (two-pass variance)."""
    x32 = x.to(F32)
    c = x32 - x32.mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def swiglu(p, x):
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def init_swiglu(draw, lead, d, f, dt):
    return {"gate": draw.normal(lead, (d, f), d ** -0.5, dt),
            "up": draw.normal(lead, (d, f), d ** -0.5, dt),
            "down": draw.normal(lead, (f, d), f ** -0.5, dt)}


def gelu_mlp(p, x):
    """GELU (tanh approximation) MLP with biases."""
    h = F.gelu(x @ p["fc1"] + p["b1"], approximate="tanh")
    return h @ p["fc2"] + p["b2"]


def init_gelu_mlp(draw, lead, d, f, dt):
    return {"fc1": draw.normal(lead, (d, f), d ** -0.5, dt), "b1": draw.full(lead, f, 0.0, dt),
            "fc2": draw.normal(lead, (f, d), f ** -0.5, dt), "b2": draw.full(lead, d, 0.0, dt)}


def apply_rope(x, positions, theta):
    """Rotary embedding, half-split form. x: (B, S, H, hd) or (B, S, hd);
    positions: (B, S). Frequencies in f32 as numpy computes them."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    ang = positions.to(F32)[..., None] * torch.from_numpy(freqs).to(x.device)
    if x.ndim == ang.ndim + 1:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def sinusoids(n_pos, d, device):
    """The (n_pos, d) sinusoid table: sin on even dims, cos on odd, built
    in float64 and cast to f32."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(d)[None, :]
    ang = pos / np.power(10_000, 2 * (dim // 2) / d)
    table = np.where(dim % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)
    return torch.from_numpy(table).to(device)


def cross_entropy(logits, labels, mask):
    """Weighted mean next-token cross entropy, logits in f32."""
    logits = logits.to(F32)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    mask = mask.to(F32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_mask(labels, batch, vocab=None):
    """1 where a label counts (>= 0, and < ``vocab`` where given), times the
    row's client weight where the batch has them."""
    ok = labels >= 0
    if vocab is not None:
        ok = ok & (labels < vocab)
    mask = ok.to(F32)
    if "client_weights" in batch:
        mask = mask * batch["client_weights"][:, None]
    return mask


def attention(q, k, v, scale, causal):
    """Softmax attention in f32. q: (B, Sq, H, hd); k, v: (B, Sk, KV, *),
    KV dividing H (grouped heads); the probabilities are rounded to v's
    dtype before the product with v."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, -1).to(F32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(F32)) * scale
    if causal:
        Sk = k.shape[1]
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(F32)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(F32)).to(q.dtype)
    return o.reshape(B, Sq, H, v.shape[-1])


def positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ----------------------------------------------------------------- trees

def leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, paths joined by '/', in sorted
    key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def unstack(tree, n):
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]
