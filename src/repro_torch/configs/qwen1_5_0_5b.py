"""qwen1.5-0.5b [dense] — QKV bias.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-0.5b")
def qwen1_5_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        arch_type="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
