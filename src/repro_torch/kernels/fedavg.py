"""The server fold ``out[n] = sum_k w[k] * x[k, n]`` behind one wrapper.

``fedavg`` is the port's counterpart of the JAX package's
``kernels/fedavg.py::fedavg_pallas`` with the same contract: stacked
(K, N) flat cohort params and (K,) weights, used as given; mixed dtypes are
promoted to their common dtype, the sum is taken in f32 and the result is
cast back to the cohort's dtype. On a CUDA tensor it launches the
hand-written kernel of ``csrc/fedavg.cu`` (or raises); on a CPU tensor it
takes the plain version, ``ref.ref_fedavg``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import LAUNCHES, load
from repro_torch.kernels.ref import ref_fedavg

# dtype codes of csrc/fedavg.cu::fedavg_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("fedavg").lib
    lib.fedavg_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.fedavg_launch.restype = ctypes.c_int
    lib.fedavg_error_string.argtypes = [ctypes.c_int]
    lib.fedavg_error_string.restype = ctypes.c_char_p
    return lib


def fedavg(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stacked: (K, N) flat cohort params; weights: (K,). Returns (N,) in
    ``stacked``'s dtype. Raises the ``ValueError``/``TypeError`` cases of
    ``fedavg_pallas``, and ``ValueError`` for tensors on two devices or a
    non-contiguous ``stacked``."""
    if stacked.ndim != 2:
        raise ValueError(
            f"fedavg: stacked must be (K, N) flat cohort params, got shape "
            f"{tuple(stacked.shape)}")
    if weights.ndim != 1 or weights.shape[0] != stacked.shape[0]:
        raise ValueError(
            f"fedavg: weights must be ({stacked.shape[0]},) to match the cohort "
            f"axis of stacked {tuple(stacked.shape)}, got {tuple(weights.shape)}")
    if not (stacked.is_floating_point() and weights.is_floating_point()):
        raise TypeError(
            f"fedavg: floating-point inputs required, got stacked={stacked.dtype}, "
            f"weights={weights.dtype}")
    if stacked.device != weights.device:
        raise ValueError(
            f"fedavg: stacked is on {stacked.device} but weights on {weights.device}")
    if not stacked.is_contiguous():
        raise ValueError("fedavg: stacked must be contiguous")
    common = torch.promote_types(stacked.dtype, weights.dtype)
    if stacked.device.type == "cpu":
        return ref_fedavg(stacked.to(common), weights.to(common)).to(stacked.dtype)
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg: no kernel for device {stacked.device}")
    if stacked.dtype not in _DTYPE_CODE or common not in _DTYPE_CODE:
        raise TypeError(
            f"fedavg: the CUDA kernel takes float32/bfloat16/float16, got "
            f"stacked={stacked.dtype}, weights={weights.dtype}")
    # round the weights to the common dtype, then hand them over in f32
    w32 = weights.to(common).to(torch.float32).contiguous()
    K, N = stacked.shape
    out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
    if N == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    rc = lib.fedavg_launch(stacked.data_ptr(), w32.data_ptr(), out.data_ptr(), K, N,
                           _DTYPE_CODE[stacked.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"fedavg: kernel launch failed: {lib.fedavg_error_string(rc).decode()}")
    LAUNCHES["fedavg"] += 1
    return out
