"""JAX-compatible threefry2x32 keys and draws, in PyTorch integer arithmetic.

The JAX package derives every random stream of a sync run from
``jax.random`` keys: client keys are ``fold_in(task_round_key, client_id)``,
``local_update`` draws its minibatch indices with ``randint`` from
``split(key, tau)``, and ``init_mlp`` draws weights with ``split`` and
``normal``. Reproducing those streams bit for bit is what makes a port run
comparable with a reference run trace for trace.

This module reimplements the threefry2x32 PRNG as JAX 0.9 computes it with
``jax_threefry_partitionable=True`` (the default): ``PRNGKey``, ``fold_in``,
``split``, 32-bit ``random_bits``, ``randint``, ``uniform``, ``normal``,
``gumbel``, ``categorical`` and ``permutation``. A key is an
int64 tensor whose last axis holds the two uint32 words; every uint32 value
is carried in int64 and wrapped with ``& 0xFFFFFFFF``. All functions
broadcast over leading key axes, so a cohort of keys is one call. They run
on whatever device the key tensor lies on.

A batched draw holds several int64 temporaries of the whole batch's size,
so ``uniform`` and ``normal`` draw key by key along the leading axis once a
batch exceeds ``MAX_BATCHED_DRAW`` values, and one key's draw that exceeds
it goes by ranges of the threefry counter: each key's draw is independent
of the others, and each value depends only on its key and its position,
so the values are the same either way.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

IntLike = Union[int, torch.Tensor]

# values drawn in one threefry call at most (1 GiB per int64 temporary,
# several of them live at once); a larger batch of keys goes key by key
MAX_BATCHED_DRAW = 2**27


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64, without ever
    forming a product that overflows int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds), elementwise over
    broadcast uint32 operands. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is
    reduced to 32 bits and the key is ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an integer
    tensor that broadcasts against ``key[..., 0]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32, idx & MASK)
    return torch.stack([b0, b1], dim=-1)


def _bits(key: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """The uint32 values (in int64) at flat positions ``start .. start+n``
    of ``jax.random.bits(key, ...)``: key (..., 2) -> (..., n)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], idx >> 32, idx & MASK)
    return b0 ^ b1


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: key (..., 2) ->
    (..., *shape) uint32 values in int64."""
    shape = tuple(int(s) for s in shape)
    return _bits(key, 0, math.prod(shape)).reshape(*key.shape[:-1], *shape)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for the default
    int32 dtype: two 32-bit draws folded into ``[minval, maxval)``
    exactly as ``jax._src.random._randint`` does. Returns int64."""
    i32 = np.iinfo(np.int32)
    minval = min(max(int(minval), i32.min), i32.max)
    maxval = min(max(int(maxval), i32.min), i32.max)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    # uint32 arithmetic: (2**16)**2 wraps to 0 when span > 2**16
    multiplier = ((2**16 % span) ** 2 & MASK) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK
    return minval + offset % span


# float32 constants of jax._src.random._normal_real / _uniform
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
_HI = np.float32(1.0)
_SQRT2 = np.float32(np.sqrt(2))

# Giles' single-precision erfinv coefficients, the float32 erf_inv that
# XLA lowers jax.lax.erf_inv to: (w < 5 branch, w >= 5 branch)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _sqrt_f32(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's ``sqrt``), for w > 0.

    PyTorch's CPU ``sqrt`` goes through MKL's vector math: it is off by an
    ulp on some inputs, and in rare processes one thread's chunk of a call
    came back with errors near 2e-4 relative. Two Newton steps in f64 from
    it leave an error far below half an f32 ulp either way."""
    w64 = w.to(torch.float64)
    s = torch.sqrt(w64)
    for _ in range(2):
        s = 0.5 * (s + w64 / s)
    return s.to(torch.float32)


# XLA:CPU's f32 log1p (a Cephes rational approximation below sqrt(2) - 1,
# log(1 + x) above) and f32 log (Cephes, on the mantissa in [sqrt(1/2),
# sqrt(2))), with the multiply-adds that XLA:CPU contracts into FMAs
_LOG1P_SMALL = np.float32(0.41421356237309504880)
_LOG1P_NUM = np.float32([4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                         6.5787325942061044846969e0, 2.9911919328553073277375e1,
                         6.0949667980987787057556e1, 5.7112963590585538103336e1,
                         2.0039553499201281259648e1])
_LOG1P_DEN = np.float32([1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                         2.2176239823732856465394e2, 3.0909872225312059774938e2,
                         2.1642788614495947685003e2, 6.0118660497603843919306e1])
_LOG_P = np.float32([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                     3.3333331174e-1])
_LOG_Q1, _LOG_Q2 = np.float32(-2.12194440e-4), np.float32(0.693359375)
_SQRTHF = np.float32(0.707106781186547524)
_MIN_NORMAL = np.float32(np.finfo(np.float32).tiny)


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding: the f32 product is exact in f64,
    the f64 sum is rounded to f32."""
    as64 = (lambda t: t.to(torch.float64) if isinstance(t, torch.Tensor) else float(t))
    return (as64(a) * as64(b) + as64(c)).to(torch.float32)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, float(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` for finite v > 0 (not correctly rounded)."""
    bits = torch.clamp(v, min=float(_MIN_NORMAL)).view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    below = m < float(_SQRTHF)
    e = e - below.to(torch.float32)
    t = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * float(_LOG_Q1))
    return (t - x2 * 0.5) + y + e * float(_LOG_Q2)


# XLA:CPU's f32 exp (Cephes: n = round(x log2 e), a = x - n ln 2 in two
# parts, a degree-7 polynomial in a, times 2**n), every multiply-add an FMA
_EXP_P = np.float32([1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
                     1.6666665459e-1, 5.0000001201e-1])
_LOG2E = np.float32(1.44269504088896341)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU flushes subnormal f32 results to zero; a torch op does not."""
    return torch.where(v.abs() < float(_MIN_NORMAL), torch.zeros_like(v), v)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp`` (not correctly rounded), subnormals flushed."""
    x = torch.clamp(x, float(np.float32(-87.8)), float(np.float32(88.8)))
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = _fma(n, -_LOG_Q2, x)
    a = _fma(n, -_LOG_Q1, a)
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = _fma(z, a, c)
    z = 1.0 + _fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(z * pow2)


def _log1p_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p`` for a > -1."""
    x2 = a * a
    r = _horner(_LOG1P_NUM, a) / _horner(_LOG1P_DEN, a)
    small = a + _fma(-0.5, x2, (a * x2) * r)
    return torch.where(a.abs() < float(_LOG1P_SMALL), small, _log_f32(1.0 + a))


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """Giles' f32 erfinv as XLA lowers ``jax.lax.erf_inv``, evaluated as
    XLA:CPU evaluates it (its log1p, and FMAs in the polynomials), so it
    equals ``jax.random.normal`` bit for bit on every device: each step is
    one correctly rounded elementwise op."""
    w = -_log1p_f32(x * -x)
    small = w < 5.0
    # the large branch only sees w >= 5; clamping keeps its unused lanes finite
    w = torch.where(small, w - 2.5, _sqrt_f32(torch.clamp(w, min=5.0)) - 3.0)
    p = torch.zeros_like(x)
    for cs, cl in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, torch.tensor(cs, dtype=x.dtype, device=x.device),
                        torch.tensor(cl, dtype=x.dtype, device=x.device))
        p = _fma(p, w, c)
    return p * x


def _draw(values, key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``values(bits)`` (an elementwise map of uint32 bits to f32) over the
    bits of ``key``'s draw of ``shape``, in calls of at most
    ``MAX_BATCHED_DRAW`` values: a batch of keys too large for one call
    goes one leading key at a time, a single key's draw too large for one
    call by ranges of its counter. The values do not depend on the split."""
    shape = tuple(int(s) for s in shape)
    if key.device.type == "meta":
        # no values to draw: a meta init (shapes and dtypes only) skips the
        # threefry graph, which the meta device walks op by op on the host
        return torch.empty(*key.shape[:-1], *shape, dtype=torch.float32, device="meta")
    n = math.prod(shape)
    if key.ndim >= 2 and key[..., 0].numel() * n > MAX_BATCHED_DRAW:
        out = torch.empty(*key.shape[:-1], *shape, dtype=torch.float32, device=key.device)
        for i in range(key.shape[0]):
            out[i] = _draw(values, key[i], shape)
        return out
    if key.ndim == 1 and n > MAX_BATCHED_DRAW:
        out = torch.empty(n, dtype=torch.float32, device=key.device)
        step = max(MAX_BATCHED_DRAW, 1)
        for start in range(0, n, step):
            stop = min(n, start + step)
            out[start:stop] = values(_bits(key, start, stop - start))
        return out.reshape(shape)
    return values(_bits(key, 0, n)).reshape(*key.shape[:-1], *shape)


def _uniform_values(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    # f32 bounds as exact Python scalars: no host-to-device copy, which on a
    # card would sync the host
    lo = np.float32(minval)
    span, lo = float(np.float32(maxval) - lo), float(lo)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats * span + lo, min=lo)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits."""
    return _draw(lambda bits: _uniform_values(bits, minval, maxval), key, shape)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with u
    uniform on ``(nextafter(-1, 0), 1)``."""
    return _draw(lambda bits: _SQRT2.item() * _erfinv_f32(
        _uniform_values(bits, float(_LO), float(_HI))), key, shape)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, its default ("low") mode:
    ``-log(-log(u))`` with u uniform on ``[tiny, 1)``, through XLA:CPU's
    f32 log, so the values are the same on every device."""
    return _draw(lambda bits: -_log_f32(-_log_f32(
        _uniform_values(bits, float(_MIN_NORMAL), 1.0))), key, shape)


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: Sequence[int] = None) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the argmax over the last
    axis of gumbel noise plus ``logits`` (the first maximum on a tie).
    ``shape`` is each key's result shape, the batch shape of its logits
    (their shape without the last axis) at its end; the leading rest are
    independent draws. As every draw here, it broadcasts over leading key
    axes: keys (..., 2) take logits (..., *batch, S), the key axes first.
    Returns int64."""
    lead = tuple(key.shape[:-1])
    if tuple(logits.shape[:len(lead)]) != lead:
        raise ValueError(f"categorical logits {tuple(logits.shape)} do not lead with the "
                         f"key axes {lead}")
    batch = tuple(logits.shape[len(lead):-1])
    shape = batch if shape is None else tuple(int(s) for s in shape)
    try:
        fits = tuple(torch.broadcast_shapes(shape, batch)) == shape
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"categorical shape {shape} is not broadcast-compatible with the "
                         f"batch shape {batch}")
    noise = gumbel(key, (*shape, logits.shape[-1]))
    return torch.argmax(noise + logits.reshape(*lead, *(1,) * (len(shape) - len(batch)),
                                               *batch, logits.shape[-1]), dim=-1)


def permutation(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation(key, x)`` of a tensor, along its first axis:
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a ``split``, a 32-bit
    random key per element and a stable sort of the elements by key, as
    ``jax._src.random._shuffle`` does (XLA sorts stably there too). A
    tensor of more than one axis moves its rows by a shuffle of their
    indices."""
    if x.ndim != 1:
        return x[permutation(key, torch.arange(x.shape[0], device=x.device))]
    rounds = math.ceil(3 * math.log(max(1, x.numel())) / math.log(MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, x.shape), stable=True).indices
        x = x[order]
    return x
