"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400. [arXiv:2405.04434]
V2-Lite: 2 shared and 64 routed experts, top-6, no q compression; the
first layer is dense with d_ff=10944 (model card). Field for field the
JAX package's config.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        arch_type="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,            # dense first layer
        vocab_size=102400,
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=0,         # V2-Lite: no q compression
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        norm_topk=True,
        rope_theta=10_000.0,
    )
