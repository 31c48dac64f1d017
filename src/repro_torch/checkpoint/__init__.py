"""Mid-run checkpoints in the JAX package's layout (``checkpoint.py``)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    ResumeState,
    load_pytree,
    save_pytree,
    to_device,
)
