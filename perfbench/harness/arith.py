"""The benchmark's arithmetic: peaks of the card, bytes bounds of the
kernels, the FLOPs a training step needs, and the tokens a round trains.

Peaks are the NVIDIA H100 SXM data sheet's, at its 700 W limit: HBM3 at
3.35 TB/s; f32 work at the three-pass TF32 rate, 494.7 / 3 TFLOP/s (the
least time the card can take for f32-accurate products on its tensor
cores; plain f32 on the CUDA cores peaks at 67 TFLOP/s).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 494.7e12 / 3


def fedavg_bytes(K: int, N: int, size: int = 4) -> int:
    """The fold: K x N params and K f32 weights read once, N written once."""
    return K * N * size + 4 * K + N * size


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask keeps over S positions."""
    return S * (S + 1) // 2


def attn_pairs_flops(pairs: int, heads: int, qk: int, v: int) -> int:
    """QK^T (2 qk flops a pair) and PV (2 v flops a pair), per head."""
    return 2 * pairs * heads * (qk + v)


def swiglu_flops(d: int, f: int) -> int:
    return 3 * 2 * d * f


def gqa_proj_flops(cfg) -> int:
    """Grouped-query attention's q, k, v and o projections, a token."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d


def mla_proj_flops(cfg) -> int:
    """Multi-head latent attention's projections, a token."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return 2 * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d)


def forward_flops(cfg, S: int) -> int:
    """Matmul and attention FLOPs of one sequence's forward at S positions,
    as the family's reference module counts them (``forward_flops`` in
    ``perfbench/reference/<arch_type>.py``). Elementwise work, norms and
    the embedding lookup are not counted."""
    from perfbench.reference.mmfl import family

    return family(cfg).forward_flops(cfg, S)


def train_flops(cfg, S: int, rows: int) -> int:
    """A training step's forward and backward over ``rows`` sequences: three
    times the forward (the backward's two products a forward product);
    recompute is not counted."""
    return 3 * rows * forward_flops(cfg, S)


def round_tokens(batch: int, seq: int, tau: int) -> int:
    """Tokens a task trains in a round it has clients: rows x seq x tau."""
    return batch * seq * tau
