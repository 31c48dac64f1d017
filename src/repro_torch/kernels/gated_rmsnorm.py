"""Mamba2's output gate, ``rms_norm(x * silu(z)) * w``, behind one wrapper.

``gated_rmsnorm`` is the port's counterpart of the JAX package's
``kernels/rmsnorm.py::gated_rmsnorm_pallas`` with the same contract: in
f32, ``g = x * z * sigmoid(z)``, then ``g * rsqrt(mean(g^2) + eps) * w``
over the last axis, cast back to x's dtype. On a CUDA tensor it launches
the hand-written kernel of ``csrc/gated_rmsnorm.cu`` (or raises); on a CPU
tensor it takes the plain version, ``ref.ref_gated_rmsnorm``; on a meta
tensor its shape rule, ``shapes.gated_rmsnorm``. x and z may
be row-strided views (Mamba2's z is a column slice of its input
projection); the output is contiguous. The kernel has no backward yet, so
on CUDA a call that autograd would record raises instead.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import shapes
from repro_torch.kernels.build import launch
from repro_torch.kernels.ref import ref_gated_rmsnorm
from repro_torch.kernels.rmsnorm import NO_BACKWARD

# dtype codes of csrc/gated_rmsnorm.cu::gated_rmsnorm_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_float,
                                                               ctypes.c_int]


def _rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d) -> (rows, d) with a contiguous last axis, a view where the
    leading axes merge."""
    t2 = t.reshape(-1, d)
    return t2 if t2.stride(-1) == 1 or d == 1 else t2.contiguous()


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x, z: (..., d) of one shape; w: (d,). Returns x's shape and dtype.
    Raises ``ValueError`` for shapes that do not fit or tensors on two
    devices, ``TypeError`` for non-float or mixed x/z dtypes, and on CUDA
    ``NotImplementedError`` where autograd is live."""
    if x.ndim < 1 or z.shape != x.shape or w.shape != (x.shape[-1],):
        raise ValueError(f"gated_rmsnorm: z must be x's shape and w (d,), got x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}, w {tuple(w.shape)}")
    if not (x.is_floating_point() and z.is_floating_point() and w.is_floating_point()):
        raise TypeError(f"gated_rmsnorm: floating-point inputs required, got x={x.dtype}, "
                        f"z={z.dtype}, w={w.dtype}")
    if not (x.device == z.device == w.device):
        raise ValueError(f"gated_rmsnorm: x, z, w on {x.device}, {z.device}, {w.device}")
    if x.device.type == "cpu":
        return ref_gated_rmsnorm(x, z, w, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gated_rmsnorm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or z.requires_grad or w.requires_grad):
        raise NotImplementedError(f"gated_rmsnorm: the CUDA kernel {NO_BACKWARD}")
    if x.device.type == "meta":
        return shapes.gated_rmsnorm(x, z, w, eps)
    if x.dtype not in _DTYPE_CODE or z.dtype != x.dtype:
        raise TypeError(f"gated_rmsnorm: the CUDA kernel takes x and z of one dtype among "
                        f"float32/bfloat16/float16, got {x.dtype}, {z.dtype}")
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x2, z2 = _rows(x, d), _rows(z, d)
    w32 = w.to(torch.float32).contiguous()
    launch("gated_rmsnorm", _ARGTYPES, x.device.index, x2.data_ptr(), z2.data_ptr(),
           w32.data_ptr(), out.data_ptr(), x2.shape[0], x2.stride(0), z2.stride(0), d, eps,
           _DTYPE_CODE[x.dtype])
    return out
