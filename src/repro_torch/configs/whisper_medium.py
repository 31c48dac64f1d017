"""whisper-medium [audio] — encoder-decoder, conv frontend (stub).

24L (24 enc + 24 dec) d_model=1024 16H d_ff=4096 vocab=51865.
[arXiv:2212.04356] The mel-spectrogram and conv feature extractor are a
stub: the batch supplies precomputed frame embeddings (B, 1500, d_model).
Field for field the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        arch_type="audio",
        n_layers=24,
        n_enc_layers=24,
        enc_frames=1500,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        norm_eps=1e-5,
    )
