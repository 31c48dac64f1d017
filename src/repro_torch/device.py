"""The port's device rule: one helper that every entry point calls.

``device=None`` means ``"cuda"``. A CUDA device that is not available
raises ``RuntimeError``: there is no silent CPU path, so a run that asked
for the card never reports CPU numbers. The CPU runs only when the caller
names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument to a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def on_device(device: torch.device):
    """A context that makes ``device`` (a CUDA device) current for a kernel
    launch; a no-op when it already is, which saves the wrapper's host time
    on the common path."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
