"""Optimizers of the port: pytree-native AdamW and SGD (``optim.py``)."""
from repro_torch.optim.optim import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd,
)
