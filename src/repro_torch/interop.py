"""Carry weights between the JAX package and the port.

The JAX package's params are pytrees of arrays (for the synthetic MLPs a
list of ``{"w", "b"}`` dicts). Tests pass them across as numpy arrays, so
both sides start from identical models, and bring the port's results
back the same way to compare them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device=None) -> Any:
    """numpy (or array-like) pytree -> the same tree of tensors on
    ``device`` (``None`` means CUDA, as everywhere in the port)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensor pytree -> the same tree of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
