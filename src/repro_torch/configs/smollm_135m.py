"""smollm-135m [dense] — llama-arch small.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ModelConfig, register


@register("smollm-135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        arch_type="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
