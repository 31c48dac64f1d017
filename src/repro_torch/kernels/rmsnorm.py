"""Row-wise RMSNorm behind one wrapper.

``rmsnorm`` is the port's counterpart of the JAX package's
``kernels/rmsnorm.py::rmsnorm_pallas`` with the same contract:
``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, in f32, cast back to
x's dtype. On a CUDA tensor it launches the hand-written kernel of
``csrc/rmsnorm.cu`` (or raises); on a CPU tensor it takes the plain
version, ``ref.ref_rmsnorm``; on a meta tensor its shape rule,
``shapes.rmsnorm``. The kernel has no backward, so on CUDA (and meta) a
call of ``rmsnorm`` that autograd would record raises instead.

``rmsnorm_trainable`` is the form that training differentiates: a
``torch.autograd.Function`` whose forward is ``rmsnorm`` (the kernel on a
CUDA tensor, the plain version on a CPU one) and whose backward is the
analytic gradient in plain PyTorch (``ref.ref_rmsnorm_backward``). The
JAX package differentiates its plain ``rms_norm`` and has no backward
kernel either.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import shapes
from repro_torch.kernels.build import launch
from repro_torch.kernels.ref import ref_rmsnorm, ref_rmsnorm_backward

# dtype codes of csrc/rmsnorm.cu::rmsnorm_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int]

NO_BACKWARD = ("has no backward kernel (arch training, ROADMAP queue 1 item 12, runs on "
               "the plain versions, and RMSNorm through kernels.rmsnorm.rmsnorm_trainable); "
               "run it under torch.no_grad() or on inputs that do not require grad")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d); w: (d,). Returns x's shape and dtype. Raises
    ``ValueError`` for a w that is not (d,) or tensors on two devices,
    ``TypeError`` for non-float inputs, and on CUDA ``NotImplementedError``
    where autograd is live."""
    if x.ndim < 1 or w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: w must be ({x.shape[-1] if x.ndim else '?'},) for x of "
                         f"shape {tuple(x.shape)}, got {tuple(w.shape)}")
    if not (x.is_floating_point() and w.is_floating_point()):
        raise TypeError(f"rmsnorm: floating-point inputs required, got x={x.dtype}, "
                        f"w={w.dtype}")
    dev = x.device
    if dev != w.device:
        raise ValueError(f"rmsnorm: x is on {x.device} but w on {w.device}")
    if dev.type == "cpu":
        return ref_rmsnorm(x, w, eps)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(f"rmsnorm: the CUDA kernel {NO_BACKWARD}")
    if dev.type == "meta":
        return shapes.rmsnorm(x, w, eps)
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"rmsnorm: the CUDA kernel takes float32/bfloat16/float16 x, got {x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    w32 = w if w.dtype == torch.float32 else w.float()
    if not w32.is_contiguous():
        w32 = w32.contiguous()
    d = x.shape[-1]
    launch("rmsnorm", _ARGTYPES, dev.index, x.data_ptr(), w32.data_ptr(), out.data_ptr(),
           x.numel() // d, d, eps, code)
    return out


class _RMSNormFn(torch.autograd.Function):
    """Forward through ``rmsnorm`` (autograd is off inside ``forward``),
    backward by the analytic gradient, recomputing ``rstd`` from x."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = ref_rmsnorm_backward(g, x, w, ctx.eps)
        return dx, dw, None


def rmsnorm_trainable(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` that autograd can differentiate: the same forward (and
    the same launches), a plain backward."""
    return _RMSNormFn.apply(x, w, eps)
