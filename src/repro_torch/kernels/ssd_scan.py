"""The chunked SSD scan of Mamba2 behind one wrapper.

``ssd_scan`` is the port's counterpart of the JAX package's
``kernels/ssm_scan.py::ssd_scan_pallas`` with the same contract: x (B, H,
L, P) values, a (B, H, L) log-decays, b and c (B, H, L, N); the recurrence
``h_t = exp(a_t) h_{t-1} + b_t^T x_t``, ``y_t = c_t h_t`` from a zero state,
computed chunk by chunk in f32 and written in x's dtype. With
``return_state`` it also returns the final state (B, H, N, P) in f32, the
``h_fin`` of the model's ``ssd_chunked`` that Mamba2's prefill hands to
decode. ``chunk`` is cut to L, and a length that is not a multiple of it is
padded with identity steps (a = 0, b = x = 0), exactly as ``ssd_chunked``
pads, which changes neither y nor the final state.

On a CUDA tensor it launches the hand-written kernels of
``csrc/ssd_scan.cu`` on scratch it allocates, or raises; one call counts
once in ``LAUNCHES``. Two routes, by a size rule (``path="auto"``):

- ``"hopper"`` wherever ``hopper_takes`` holds: Mamba2's widths N = P =
  64, a chunk that is a multiple of 64 up to 256, and views TMA can read
  (zamba2-7b's scans; faster than the ``mma.sync`` kernels at both of its
  shapes, PERF.md). Two device kernels beside a memset of their flags:
  the chunk states with the pass over the chunks folded in, then the
  outputs, TMA-fed ``wgmma`` (f32 in three TF32 passes; bf16 products of
  an input and an f32 factor in three bf16 passes). b and c shared by the
  heads go ``head_group(chunk)`` heads a block, which reuse the chunk's
  scores from shared memory.
- otherwise the ``mma.sync`` kernels: four device launches (chunk scores,
  chunk states, the state pass over the chunks, chunk outputs), or, for
  chunks and states of at most 64 over at least two (batch, head) pairs
  per SM, two (chunk scores, then one block per (batch, head) walking its
  chunks); ``"chunks"`` and ``"seq"`` force one of the two.

``path`` forces a route; a route that does not take the shape refuses the
launch and the wrapper raises. On a CPU tensor it takes the plain version,
``ref.ref_ssd``, the sequential recurrence, whatever the path; on a meta
tensor its shape rule, ``shapes.ssd_scan``. The kernels read their
inputs through their strides, so Mamba2's B and C (one group shared by
all heads) go in as stride-0 head views and x as a transposed (B, L, H, P)
view, without copies; y takes x's memory layout. It has no backward yet:
on CUDA a call that autograd would record raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import shapes
from repro_torch.kernels.build import launch, load
from repro_torch.kernels.ref import ref_ssd
from repro_torch.kernels.rmsnorm import NO_BACKWARD

# dtype and path codes of csrc/ssd_scan.cu::ssd_scan_launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"auto": 0, "chunks": 1, "seq": 2, "hopper": 3}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 10
# the Hopper route: the state and head widths it takes and the chunks it
# takes (multiples of 64 up to 256)
HOPPER_WIDTH = 64
HOPPER_MAX_CHUNK = 256


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("ssd_scan").lib
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_fits.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_fits.restype = ctypes.c_int
    lib.ssd_scan_scratch_bytes.argtypes = [ctypes.c_int] * 8
    lib.ssd_scan_scratch_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _fits(N: int, P: int, chunk: int) -> bool:
    return bool(_lib().ssd_scan_fits(N, P, chunk))


@functools.lru_cache(maxsize=4096)
def _scratch_bytes(*args) -> int:
    return int(_lib().ssd_scan_scratch_bytes(*args))


def _strides_ok(shape, stride, size: int, skip_head: bool) -> bool:
    """A (B, H, L, W) view's strides as a TMA tensor map needs them: the
    last axis contiguous, every other axis longer than 1 (the head axis
    left out with ``skip_head``) a nonzero multiple of 16 bytes."""
    return stride[3] == 1 and all(shape[i] == 1 or (stride[i] > 0 and stride[i] * size % 16 == 0)
                                  for i in ((0, 2) if skip_head else (0, 1, 2)))


@functools.lru_cache(maxsize=1024)
def _takes(x_shape, x_st, b_shape, b_st, c_st, dtype, chunk: int, shared: bool) -> bool:
    """``hopper_takes`` but for the bases' alignment, by shapes, strides and
    dtype (remembered, so a repeated call pays a lookup)."""
    size = 4 if dtype == torch.float32 else 2
    return (x_shape[-1] == HOPPER_WIDTH and b_shape[-1] == HOPPER_WIDTH and chunk % 64 == 0
            and chunk <= HOPPER_MAX_CHUNK and dtype in _DTYPE_CODE
            and _strides_ok(x_shape, x_st, size, False)
            and _strides_ok(b_shape, b_st, size, shared)
            and _strides_ok(b_shape, c_st, size, shared))


def hopper_takes(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, chunk: int,
                 shared: bool) -> bool:
    """The size rule of ``path="auto"``: whether the Hopper route takes a
    call of x (B, H, L, P), b and c (B, H, L, N) at ``chunk`` (already cut
    to L): N and P of ``HOPPER_WIDTH`` (Mamba2's), a chunk that is a
    multiple of 64 up to ``HOPPER_MAX_CHUNK``, f32 or bf16, and views TMA
    can read (b's and c's head axis left out when ``shared``). Elsewhere
    the mma.sync kernels' own size rule holds."""
    return (x.data_ptr() | b.data_ptr() | c.data_ptr()) % 16 == 0 and _takes(
        x.shape, x.stride(), b.shape, b.stride(), c.stride(), x.dtype, chunk, shared)


def head_group(chunk: int) -> int:
    """Heads a block of the Hopper route takes when b and c are shared by
    the heads (the chunk's scores are computed once for them): 16 at chunks
    of 64 steps, 4 at longer ones, where a block's heads take longer and
    more, smaller blocks keep the card fuller (the fastest of 4, 8 and 16 at
    zamba2-7b's serve and loss shapes on the H100, PERF.md)."""
    return 16 if chunk <= 64 else 4


def _pad_seq(t: torch.Tensor, Lp: int) -> torch.Tensor:
    """Zero-pad axis 2 (the sequence) to Lp; a stride-0 head axis stays one."""
    pad = [0, 0] * (t.ndim - 3) + [0, Lp - t.shape[2]]
    if t.shape[1] > 1 and t.stride(1) == 0:
        return F.pad(t[:, :1], pad).expand(-1, t.shape[1], *([-1] * (t.ndim - 2)))
    return F.pad(t, pad)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             chunk: int = 128, return_state: bool = False, path: str = "auto"):
    """x: (B, H, L, P); a: (B, H, L); b, c: (B, H, L, N). Returns y like x,
    and with ``return_state`` the pair (y, final state (B, H, N, P) f32).
    ``path`` picks the CUDA kernels: ``"auto"`` by size (``hopper_takes``,
    then the ``mma.sync`` kernels' own rule), ``"hopper"`` the TMA/wgmma
    route (N = P = 64, chunk a multiple of 64 up to 256), ``"chunks"`` the
    chunk-parallel ``mma.sync`` kernels, ``"seq"`` the one that walks each
    (batch, head)'s chunks (chunks and N at most 64); the CPU ignores it.
    Raises ``ValueError`` for shapes that do not fit, a chunk < 1, an
    unknown path or tensors on two devices, ``TypeError`` for non-float or mixed x/b/c
    dtypes, and on CUDA ``NotImplementedError`` where autograd is live and
    ``RuntimeError`` where the kernel refuses the launch (a chunk whose
    cumsum and tiles do not fit in shared memory, P > 128, or a shape the
    forced route does not take)."""
    if x.ndim != 4 or a.shape != x.shape[:3] or b.ndim != 4 or b.shape[:3] != x.shape[:3] \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan: x must be (B, H, L, P), a (B, H, L) and b, c (B, H, L, N), "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"ssd_scan: chunk must be >= 1, got {chunk}")
    if path not in _PATH_CODE:
        raise ValueError(f"ssd_scan: path must be one of {sorted(_PATH_CODE)}, got {path!r}")
    if not all(t.is_floating_point() for t in (x, a, b, c)) or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b, c must share one float dtype and a be float, got "
                        f"{x.dtype}, {a.dtype}, {b.dtype}, {c.dtype}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError(f"ssd_scan: x, a, b, c on {x.device}, {a.device}, {b.device}, "
                         f"{c.device}")
    B, H, L, P = x.shape
    N = b.shape[-1]
    chunk = max(1, min(int(chunk), L))
    Lp = -(-L // chunk) * chunk
    if Lp != L:
        x, a, b, c = (_pad_seq(t, Lp) for t in (x, a, b, c))
    if x.device.type == "cpu":
        y, h = ref_ssd(x, a, b, c, return_state=True)
        y = y[:, :, :L]
        return (y, h) if return_state else y
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b, c)):
        raise NotImplementedError(f"ssd_scan: the CUDA kernel {NO_BACKWARD}")
    if x.device.type == "meta":
        y, h = shapes.ssd_scan(x, a, b, c, chunk)
        return (y[:, :, :L], h) if return_state else y[:, :, :L]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_scan: the CUDA kernel takes float32/bfloat16, got {x.dtype}")
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    y = torch.empty_like(x)             # x's layout: (B, L, H, P) memory for the model's views
    h = torch.empty(B, H, N, P, dtype=torch.float32, device=x.device) if return_state else None
    if x.numel() == 0 or b.numel() == 0:
        if h is not None:
            h.zero_()
        y.zero_()
        return (y[:, :, :L], h) if return_state else y[:, :, :L]
    if a.dtype != torch.float32:
        a = a.float()
    # b and c one group for every head (Mamba2's call): the chunk's scores
    # C B^T are computed once for all heads
    shared = H == 1 or (b.stride(1) == 0 and c.stride(1) == 0)
    code = _PATH_CODE[path]
    if code == 0 and hopper_takes(x, b, c, chunk, shared):
        code = 3
    if code != 3 and not _fits(N, P, chunk):
        raise RuntimeError(
            f"ssd_scan: the kernel refuses chunk {chunk}, N={N}, P={P}: it takes P up to 128 "
            f"and a chunk whose tiles and cumsum fit in a block's shared memory (these need "
            f"{_lib().ssd_scan_smem_bytes(N, P, chunk)} bytes)")
    scratch = torch.empty(_scratch_bytes(B, H, Lp, N, P, chunk, int(shared), code),
                          dtype=torch.uint8, device=x.device)
    strides = [s for t in (x, a, b, c, y) for s in t.stride()[:3]]
    launch("ssd_scan", _ARGTYPES, x.device.index, x.data_ptr(), a.data_ptr(), b.data_ptr(),
           c.data_ptr(), y.data_ptr(), 0 if h is None else h.data_ptr(), scratch.data_ptr(),
           *strides, B, H, Lp, P, N, chunk, int(shared), _DTYPE_CODE[x.dtype], code,
           head_group(chunk) if shared else 1)
    if Lp != L:
        y = y[:, :, :L]
    return (y, h) if return_state else y
