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

import torch

from repro_torch.kernels.build import launch
from repro_torch.kernels.ref import ref_fedavg

# dtype codes of csrc/fedavg.cu::fedavg_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# (stacked dtype, weights dtype) the kernel takes -> (stacked's code, their common dtype)
_CODES = {(x, w): (code, torch.promote_types(x, w)) for x, code in _DTYPE_CODE.items()
          for w in _DTYPE_CODE}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int]


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
    dev = stacked.device
    if dev != weights.device:
        raise ValueError(
            f"fedavg: stacked is on {stacked.device} but weights on {weights.device}")
    if not stacked.is_contiguous():
        raise ValueError("fedavg: stacked must be contiguous")
    if dev.type == "cpu":
        common = torch.promote_types(stacked.dtype, weights.dtype)
        return ref_fedavg(stacked.to(common), weights.to(common)).to(stacked.dtype)
    if dev.type != "cuda":
        raise ValueError(f"fedavg: no kernel for device {stacked.device}")
    codes = _CODES.get((stacked.dtype, weights.dtype))
    if codes is None:
        raise TypeError(
            f"fedavg: the CUDA kernel takes float32/bfloat16/float16, got "
            f"stacked={stacked.dtype}, weights={weights.dtype}")
    code, common = codes
    # round the weights to the common dtype, then hand them over in f32
    w32 = weights if weights.dtype == common else weights.to(common)
    if w32.dtype != torch.float32:
        w32 = w32.float()
    if not w32.is_contiguous():
        w32 = w32.contiguous()
    K, N = stacked.shape
    out = stacked.new_empty(N)
    if N:
        launch("fedavg", _ARGTYPES, dev.index, stacked.data_ptr(), w32.data_ptr(),
               out.data_ptr(), K, N, code)
    return out
