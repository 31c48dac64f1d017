"""Forward flash attention (causal switch, GQA) behind one wrapper.

``flash_attention`` is the port's counterpart of the JAX package's
``kernels/flash_attention.py::flash_attention_pallas`` with the same
contract: q (B, H, Sq, hd), k and v (B, KV, Sk, hd) -> (B, H, Sq, hd) in
q's dtype; head h reads kv head ``h // (H // KV)``; scale ``hd^-0.5``;
causal is top-left aligned (query i sees keys 0..i). On a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (or
raises); on a CPU tensor it takes the plain version, ``ref.ref_attention``;
on a meta tensor its shape rule, ``shapes.flash_attention``.
The kernel reads its inputs through their strides (TMA tensor maps), so
the model's transposed (B, S, H, hd) views go in without a copy (a view
whose rows do not start on 16 bytes, or that repeats rows by a zero
stride, is copied first), and the output has q's memory layout. It has
no backward yet: on CUDA a call that autograd would record raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import shapes
from repro_torch.kernels.build import launch
from repro_torch.kernels.ref import ref_attention
from repro_torch.kernels.rmsnorm import NO_BACKWARD

# dtype codes of csrc/flash_attention.cu::flash_attention_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 112, 128)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int]


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` (its last axis) is contiguous and starts on
    16 bytes, and every other axis longer than 1 has a nonzero stride of a
    multiple of 16 bytes, as the kernel's TMA tensor maps need (an axis of
    length 1 never moves, so its stride does not matter)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s * size % 16 == 0)
                    for s, n in zip(t.stride()[:-1], t.shape[:-1])))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd). Returns (B, H, Sq, hd).
    Raises ``ValueError`` for shapes that do not fit together or tensors on
    two devices, ``TypeError`` for mixed or non-float dtypes, and on CUDA
    ``NotImplementedError`` where autograd is live."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, H, Sq, hd) and k, v (B, KV, Sk, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV or Sq == 0 or Sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k, v {tuple(k.shape)} do not "
                         "fit (same B and hd, H a multiple of KV, Sq and Sk non-empty)")
    if not q.is_floating_point() or q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one float dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(f"flash_attention: the CUDA kernel {NO_BACKWARD}")
    if q.device.type == "meta":
        return shapes.flash_attention(q, k, v, causal)
    if q.dtype not in _DTYPE_CODE or hd not in HEAD_DIMS:
        raise TypeError(f"flash_attention: the CUDA kernel takes float32/bfloat16 and hd in "
                        f"{HEAD_DIMS}, got {q.dtype} and hd={hd}")
    q, k, v = (t if rows_aligned(t) else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)  # q's layout: (B, S, H, hd) memory for the model's views
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    launch("flash_attention", _ARGTYPES, q.device.index, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), *strides, B, H, KV, Sq, Sk, hd, hd ** -0.5,
           int(causal), _DTYPE_CODE[q.dtype])
    return out
