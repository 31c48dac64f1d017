"""The port's LM: the dense decoder-only family of the JAX package."""
from repro_torch.models.model import ModelApi, get_api, pad_cache, param_count  # noqa: F401
