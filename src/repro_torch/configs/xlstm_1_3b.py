"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks.

48L d_model=2048 4H d_ff=0 vocab=50304. [arXiv:2405.04517]
d_ff=0: blocks carry internal expansion (mLSTM proj_factor=2; sLSTM gated
FFN 4/3). sLSTM every 8th layer ([7:1] mLSTM:sLSTM, xLSTM paper large cfg).
"""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-1.3b")
def xlstm_1_3b() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        arch_type="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm_expand=2,
        ssm_chunk=256,
        slstm_every=8,
    )
