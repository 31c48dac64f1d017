"""qwen3-0.6b [dense] — qk_norm, GQA, head_dim 128.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-0.6b")
def qwen3_0_6b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        arch_type="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
