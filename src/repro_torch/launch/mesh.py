"""Device meshes: the cohort mesh of the ``sharded`` backend, the
production mesh and small test meshes.

The port's counterpart of the JAX package's ``launch/mesh.py``, defined
as FUNCTIONS so that importing this module touches no CUDA or
process-group state. Single pod: 16x16 = 256 ranks ('data', 'model').
Multi-pod: 2 pods = 512 ranks ('pod', 'data', 'model'), the pod axis
being pure data parallelism. The production and test meshes are
``torch.distributed`` ``DeviceMesh``es over the ranks of the process
group the caller initialised (one rank a card); the cohort mesh is a
tuple of ``torch.device``s of this process.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


def _group_mesh(shape, axes, device_type: str):
    """A mesh of ``shape`` over the first ranks of the initialised process
    group; ``RuntimeError`` naming both counts when the group is smaller."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, have {have}: initialise a process group "
            f"of at least {n} ranks (torch.distributed.init_process_group) first")
    if have == n:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _group_mesh(shape, axes, "cuda")


def make_cohort_mesh(n_devices=None, device=None) -> tuple:
    """1-D mesh of this process's devices: the cohort axis the ``sharded``
    execution backend splits client updates across (each device runs a
    part of the cohort's local updates; the fold gathers them on the
    primary device). On CUDA every card by default, ``n_devices`` clipped
    to [1, device_count]; ``(cpu,)`` for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,)
    count = torch.cuda.device_count()
    n = count if n_devices is None else max(1, min(int(n_devices), count))
    return tuple(torch.device("cuda", i) for i in range(n))


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda"):
    """Small mesh for tests over the current process group (``"cpu"``
    with gloo)."""
    return _group_mesh(shape, axes, device_type)
