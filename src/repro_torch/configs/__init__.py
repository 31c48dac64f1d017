"""Config registry of the port: importing this package registers every
arch of the JAX package (the dense ones, qwen2-moe, deepseek-v2-lite, the
zamba2 hybrid, xlstm, whisper and phi-3-vision)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_archs,
    smoke_config,
)
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_lite_16b,
    phi3_vision_4_2b,
    qwen1_5_0_5b,
    qwen1_5_110b,
    qwen2_moe_a2_7b,
    qwen3_0_6b,
    smollm_135m,
    whisper_medium,
    xlstm_1_3b,
    zamba2_7b,
)

# the JAX package's assigned archs, in its order
ASSIGNED_ARCHS = (
    "zamba2-7b",
    "phi-3-vision-4.2b",
    "qwen3-0.6b",
    "deepseek-v2-lite-16b",
    "qwen2-moe-a2.7b",
    "smollm-135m",
    "xlstm-1.3b",
    "whisper-medium",
    "qwen1.5-0.5b",
    "qwen1.5-110b",
)
