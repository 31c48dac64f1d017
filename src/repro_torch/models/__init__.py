"""The port's LMs: the dense and MoE decoder-only families, the zamba2
hybrid and the xLSTM LM of the JAX package."""
from repro_torch.models.model import (ModelApi, active_param_count, get_api,  # noqa: F401
                                      pad_cache, param_count)
