"""The async flush with a server optimizer in one pass, behind one wrapper.

``fused_aggregate`` is the port's counterpart of the JAX package's
``kernels/fedavg.py::fused_aggregate_pallas`` with the same contract: the
FedAST staleness discount of the (K,) weights, normalised by the
undiscounted weight sum the caller passes as ``normalizer``, the weighted
reduce of the (K, N) stacked cohort deltas, and the FedOpt moment update
of the (N,) server moments ``m``/``v``, all in f32. It returns
``(update, new_m, new_v)``; a mode that leaves a moment unchanged returns
the input moment itself, uncopied. On a CUDA tensor it launches the
hand-written kernel of ``csrc/fused_aggregate.cu`` (or raises); on a CPU
tensor it takes the plain version, ``ref.ref_fused_aggregate``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import launch
from repro_torch.kernels.ref import ref_fused_aggregate

FUSED_MODES = ("fedavg", "fedavgm", "fedadam", "fedyogi")
_MODE_CODE = {mode: i for i, mode in enumerate(FUSED_MODES)}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_float] * 6)


def _check(stacked, weights, staleness, m, v, mode):
    if mode not in FUSED_MODES:
        raise ValueError(
            f"fused_aggregate: unknown mode {mode!r}; valid: {', '.join(FUSED_MODES)}")
    if stacked.ndim != 2:
        raise ValueError(
            f"fused_aggregate: stacked must be (K, N), got shape {tuple(stacked.shape)}")
    K, N = stacked.shape
    for name, a, n in (("weights", weights, K), ("staleness", staleness, K),
                       ("m", m, N), ("v", v, N)):
        if tuple(a.shape) != (n,):
            raise ValueError(
                f"fused_aggregate: {name} must be ({n},) to match stacked "
                f"{tuple(stacked.shape)}, got {tuple(a.shape)}")
        if not a.is_floating_point():
            raise TypeError(f"fused_aggregate: {name} must be floating point, got {a.dtype}")
        if a.device != stacked.device:
            raise ValueError(
                f"fused_aggregate: stacked is on {stacked.device} but {name} on {a.device}")
    if not stacked.is_floating_point():
        raise TypeError(f"fused_aggregate: stacked must be floating point, got {stacked.dtype}")


def fused_aggregate(stacked: torch.Tensor, weights: torch.Tensor, staleness: torch.Tensor,
                    m: torch.Tensor, v: torch.Tensor, *, mode: str, beta, normalizer,
                    lr=1.0, beta1=0.9, beta2=0.99, eps=1e-3):
    """stacked: (K, N) client deltas; weights, staleness: (K,); m, v: (N,)
    server moments (any placeholder of that shape for a moment the mode
    ignores). ``normalizer`` is a host number or a 0-d tensor (a device
    tensor is read back). Inputs are taken in f32. Returns ``(update,
    new_m, new_v)``, each (N,) f32."""
    _check(stacked, weights, staleness, m, v, mode)
    if stacked.device.type == "cpu":
        return ref_fused_aggregate(stacked, weights, staleness, m, v, mode=mode, beta=beta,
                                   normalizer=normalizer, lr=lr, beta1=beta1, beta2=beta2,
                                   eps=eps)
    if stacked.device.type != "cuda":
        raise ValueError(f"fused_aggregate: no kernel for device {stacked.device}")
    f32 = torch.float32
    x, w, s, m, v = (t.to(f32).contiguous() for t in (stacked, weights, staleness, m, v))
    K, N = x.shape
    # 1 / max(normalizer, 1e-12) in f32, as the Pallas kernel's scalar row
    inv_norm = np.float32(1.0) / np.maximum(np.float32(float(normalizer)), np.float32(1e-12))
    upd = torch.empty(N, dtype=f32, device=x.device)
    om = m if mode == "fedavg" else torch.empty_like(upd)
    ov = torch.empty_like(upd) if mode in ("fedadam", "fedyogi") else v
    if N == 0:
        return upd, om, ov
    launch("fused_aggregate", _ARGTYPES, x.device.index,
           x.data_ptr(), w.data_ptr(), s.data_ptr(), m.data_ptr(), v.data_ptr(), upd.data_ptr(),
           None if om is m else om.data_ptr(), None if ov is v else ov.data_ptr(), K, N,
           _MODE_CODE[mode], float(beta), float(inv_norm), float(lr), float(beta1),
           float(beta2), float(eps))
    return upd, om, ov
