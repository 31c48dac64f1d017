"""Carry weights between the JAX package and the port.

The JAX package's params are pytrees of arrays (for the synthetic MLPs a
list of ``{"w", "b"}`` dicts; for the LM a nested dict with the layers
stacked on axis 0). Tests pass them across as numpy arrays, so both sides
start from identical models, and bring the port's results back the same
way to compare them. ``lm_params_from_numpy`` checks an LM tree against
the port's own before it carries it across; ``adamw_state_from_numpy``
carries an AdamW state (``mu``, ``nu``, ``count``), so both optimizers can
start from one state. ``load_numpy_pytree`` reads the checkpoint layout
both packages share (``arrays.npz`` and ``MANIFEST.json``) as a numpy
tree; ``repro_torch.checkpoint.save_pytree`` writes numpy trees as it
writes tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(tree: Any, device=None) -> Any:
    """numpy (or array-like) pytree -> the same tree of tensors on
    ``device`` (``None`` means CUDA, as everywhere in the port)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensor pytree -> the same tree of numpy arrays on the host; a
    DTensor leaf is gathered whole first (``full_tensor``)."""
    def host(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().cpu().numpy()

    return tree_map(host, tree)


def _tensor(a) -> torch.Tensor:
    """numpy array -> CPU tensor; bfloat16 (``ml_dtypes``) goes by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_numpy(tree: Any, cfg, device=None) -> Any:
    """A JAX LM param tree (nested dicts of numpy arrays) -> the port's
    params on ``device`` (``None`` means CUDA). Every key, shape and dtype
    must be those of the tree the port's ``get_api(cfg).init_params``
    builds (the dense LM or the hybrid); a mismatch raises ``ValueError``
    naming the leaf."""
    from repro_torch.models import get_api

    dev = resolve_device(device)
    want = get_api(cfg).init_params(prng.PRNGKey(0, device="meta"), cfg, device="meta")

    def carry(got, ref, path):
        if isinstance(ref, dict):
            if not isinstance(got, dict) or set(got) != set(ref):
                have = sorted(got) if isinstance(got, dict) else type(got).__name__
                raise ValueError(f"lm_params_from_numpy: {path or 'params'} has keys {have}, "
                                 f"the port's {cfg.name} has {sorted(ref)}")
            return {k: carry(got[k], ref[k], f"{path}/{k}" if path else k) for k in ref}
        t = _tensor(got)
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"lm_params_from_numpy: {path} is {tuple(t.shape)} {t.dtype}, "
                             f"the port's {cfg.name} has {tuple(ref.shape)} {ref.dtype}")
        return t.to(dev)

    return carry(tree, want, "")


def adamw_state_from_numpy(state: Any, device=None) -> Any:
    """A JAX ``optim.adamw`` state (``{"mu", "nu", "count"}`` of numpy
    arrays) -> the port's on ``device`` (``None`` means CUDA): f32 moments
    of the same trees, ``count`` an int32 scalar."""
    dev = resolve_device(device)
    moments = {k: tree_map(lambda a: _tensor(a).to(torch.float32).to(dev), state[k])
               for k in ("mu", "nu")}
    count = torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32, device=dev)
    return {**moments, "count": count}


def load_numpy_pytree(path: str):
    """A pytree saved by either package's ``save_pytree`` as numpy arrays
    of the recorded dtypes, bf16 leaves widened exactly to float32 (numpy
    has no bf16). Returns (tree, metadata)."""
    from repro_torch.checkpoint.checkpoint import _rebuild, read_arrays

    manifest, raw = read_arrays(path)
    dtypes = manifest["dtypes"]
    arrays = {k: (v.astype(np.uint32) << 16).view(np.float32) if dtypes.get(k) == "bfloat16"
              else v for k, v in raw.items()}
    return _rebuild(manifest["structure"], arrays), manifest["metadata"]
