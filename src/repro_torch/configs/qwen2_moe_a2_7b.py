"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) d_ff(expert)=1408 vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B] Shared-expert width = 4x1408 (shared experts are
fused into one wide expert, as in the HF impl); router without top-k prob
normalization (norm_topk_prob=False in the model card).
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,             # kept for reference; experts use moe_d_ff
        vocab_size=151936,
        qkv_bias=True,
        n_experts=60,
        n_shared_experts=4,
        top_k=4,
        moe_d_ff=1408,
        norm_topk=False,
        rope_theta=1_000_000.0,
    )
