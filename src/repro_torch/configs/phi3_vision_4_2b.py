"""phi-3-vision-4.2b [vlm] — phi3-mini decoder + CLIP frontend (stub).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct] The vision encoder and projector
are a stub, as in the JAX package: the model takes precomputed patch
embeddings (B, 256, d_model) ahead of the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi-3-vision-4.2b")
def phi3_vision() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        arch_type="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        n_img_tokens=256,
        rope_theta=10_000.0,
    )
