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
``csrc/ssd_scan.cu`` (four device launches: chunk scores, chunk states,
the state pass over the chunks, chunk outputs; or, for chunks and states
of at most 64 over at least two (batch, head) pairs per SM, two: chunk
scores, then one block per (batch, head) walking its chunks; ``path``
forces one of the two; one call counts once in ``LAUNCHES``) on scratch
it allocates, or raises; on a CPU tensor it
takes the plain version, ``ref.ref_ssd``, the sequential recurrence; on
a meta tensor its shape rule, ``shapes.ssd_scan``. The
kernels read their inputs through their strides, so Mamba2's B and C (one
group shared by all heads) go in as stride-0 head views and x as a
transposed (B, L, H, P) view, without copies; y takes x's memory layout.
It has no backward yet: on CUDA a call that autograd would record raises.
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
_PATH_CODE = {"auto": 0, "chunks": 1, "seq": 2}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 15 + [ctypes.c_int] * 9


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load("ssd_scan").lib
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_fits.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_fits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _fits(N: int, P: int, chunk: int) -> bool:
    return bool(_lib().ssd_scan_fits(N, P, chunk))


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
    ``path`` picks the CUDA kernels: ``"auto"`` by size, ``"chunks"`` the
    chunk-parallel ones, ``"seq"`` the one that walks each (batch, head)'s
    chunks (chunks and N at most 64); the CPU ignores it.
    Raises ``ValueError`` for shapes that do not fit, a chunk < 1, an
    unknown path or tensors on two devices, ``TypeError`` for non-float or mixed x/b/c
    dtypes, and on CUDA ``NotImplementedError`` where autograd is live and
    ``RuntimeError`` where the kernel refuses the launch (a chunk whose
    cumsum and tiles do not fit in shared memory, or P > 128)."""
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
    lib = _lib()
    if a.dtype != torch.float32:
        a = a.float()
    if not _fits(N, P, chunk):
        raise RuntimeError(
            f"ssd_scan: the kernel refuses chunk {chunk}, N={N}, P={P}: it takes P up to 128 "
            f"and a chunk whose tiles and cumsum fit in a block's shared memory (these need "
            f"{lib.ssd_scan_smem_bytes(N, P, chunk)} bytes)")
    Z = Lp // chunk
    # b and c one group for every head (Mamba2's call): the chunk's scores
    # C B^T are computed once for all heads
    shared = H == 1 or (b.stride(1) == 0 and c.stride(1) == 0)
    # scratch of the chunk-parallel scan, one f32 allocation: each chunk's
    # scores ((B, Z, Q, Q), or (B, H, Z, Q, Q) per head); each chunk's state,
    # then the state entering it (B, H, Z, N, P), from a 16-byte boundary;
    # each chunk's total log-decay (B, H, Z)
    n_scores = B * (1 if shared else H) * Z * chunk * chunk
    n_states = B * H * Z * N * P
    off = -(-n_scores // 4) * 4
    scratch = torch.empty(off + n_states + B * H * Z, dtype=torch.float32, device=x.device)
    base = scratch.data_ptr()
    strides = [s for t in (x, a, b, c, y) for s in t.stride()[:3]]
    launch("ssd_scan", _ARGTYPES, x.device.index, x.data_ptr(), a.data_ptr(), b.data_ptr(),
           c.data_ptr(), y.data_ptr(), 0 if h is None else h.data_ptr(), base + 4 * off,
           base + 4 * (off + n_states), base, *strides, B, H, Lp, P, N, chunk, int(shared),
           _DTYPE_CODE[x.dtype], _PATH_CODE[path])
    if Lp != L:
        y = y[:, :, :L]
    return (y, h) if return_state else y
