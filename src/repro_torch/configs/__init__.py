"""Config registry of the port: importing this package registers the
archs it runs (the dense ones, qwen2-moe, the zamba2 hybrid and xlstm).
The other three archs of the JAX package come with their families
(ROADMAP queue 1 items 10-11)."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_archs,
    smoke_config,
)
from repro_torch.configs import (  # noqa: F401
    qwen1_5_0_5b,
    qwen1_5_110b,
    qwen2_moe_a2_7b,
    qwen3_0_6b,
    smollm_135m,
    xlstm_1_3b,
    zamba2_7b,
)
