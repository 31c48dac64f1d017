"""The port's device rule: one helper that every entry point calls.

``device=None`` means ``"cuda"``. A CUDA device that is not available
raises ``RuntimeError``: there is no silent CPU path, so a run that asked
for the card never reports CPU numbers. The CPU runs only when the caller
names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument to a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev

