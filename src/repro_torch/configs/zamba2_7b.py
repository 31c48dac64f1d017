"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242] Shared transformer block applied every 6 Mamba2 layers,
with per-invocation LoRA adapters on the shared projections (Zamba2's
signature weight-sharing trick).
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        arch_type="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv=4,
        ssm_chunk=256,
        attn_every=6,
        shared_attn_lora_rank=128,
        rope_theta=10_000.0,
    )
