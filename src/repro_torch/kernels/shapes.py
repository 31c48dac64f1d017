"""The kernels' shape rules on the meta device, and their own work.

A wrapper given meta tensors (a shape-only run: the dry-run,
``launch/dryrun.py``) calls the matching operator here, ``torch.ops.
repro_torch.<kernel>``: a ``torch.library`` custom op whose only
implementation is its fake one, the kernel's output shapes as empty
tensors, with no arithmetic. It is never called on a device.

Each op carries the kernel's own work, so a counter that reads the
operators of a run (``launch/op_analysis.py``, or ``torch.utils.
flop_counter.FlopCounterMode``, where the formulas are registered)
books the kernel, not its plain version's S x S scores or chunk loops:

* ``flops``: flash 4 hd per (query, key) pair the mask keeps; the SSD
  scan the scores C_i . B_j, 2 N per causal pair of a chunk, once per
  (batch, chunk) when b and c are one group for all heads, else per
  head, and per head the product with x, 2 P per pair, and 2 N P per step
  for each of the carry-in and the chunk state; RMSNorm 4 per element
  (the square, the sum, the two scalings), the gated norm 7 (the gate's
  three, the sigmoid counted as one, and the norm's four). These are
  the formulas of the bounds ``chip_smoke.py`` holds the kernels to.
* ``nbytes``: each input read once (a stride-0 view of a shared head
  axis once) and each output written once.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

SHAPE_ONLY = "a shape rule of the meta device: it has no implementation on a device"


def _numel(t) -> int:
    """Elements a kernel reads of ``t``: a stride-0 axis counts once."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def _nbytes(*tensors) -> int:
    return sum(_numel(t) * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------- the ops

@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    raise RuntimeError(f"repro_torch::rmsnorm: {SHAPE_ONLY}")


@rmsnorm.register_fake
def _(x, w, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::gated_rmsnorm", mutates_args=())
def gated_rmsnorm(x: Tensor, z: Tensor, w: Tensor, eps: float) -> Tensor:
    raise RuntimeError(f"repro_torch::gated_rmsnorm: {SHAPE_ONLY}")


@gated_rmsnorm.register_fake
def _(x, z, w, eps):
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    raise RuntimeError(f"repro_torch::flash_attention: {SHAPE_ONLY}")


@flash_attention.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan(x: Tensor, a: Tensor, b: Tensor, c: Tensor, chunk: int) -> tuple[Tensor, Tensor]:
    raise RuntimeError(f"repro_torch::ssd_scan: {SHAPE_ONLY}")


@ssd_scan.register_fake
def _(x, a, b, c, chunk):
    B, H, _, P = x.shape
    return torch.empty_like(x), x.new_empty((B, H, b.shape[-1], P), dtype=torch.float32)


# ---------------------------------------------------------------- their work

def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a top-left aligned causal mask keeps."""
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def ssd_flops(B, H, L, P, N, chunk, shared_bc: bool) -> int:
    Z, Q = -(-L // chunk), min(chunk, L)
    pairs = B * Z * Q * (Q + 1) // 2
    scores = 2 * N * pairs * (1 if shared_bc else H)
    return scores + H * (2 * P * pairs + 4 * B * Z * Q * N * P)


def _shared_bc(b, c) -> bool:
    return b.shape[1] == 1 or (b.stride(1) == 0 and c.stride(1) == 0)


def work(name: str, args, out) -> tuple:
    """(flops, bytes) of one call of kernel ``name`` on ``args`` (tensors
    with shapes and strides, meta ones included) that returned ``out``."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    tensors = [a for a in args if isinstance(a, Tensor)]
    nbytes = _nbytes(*tensors, *outs)
    if name == "rmsnorm":
        return 4 * args[0].numel(), nbytes
    if name == "gated_rmsnorm":
        return 7 * args[0].numel(), nbytes
    if name == "flash_attention":
        q, k, _, causal = args[:4]
        B, H, Sq, hd = q.shape
        pairs = causal_pairs(Sq, k.shape[2]) if causal else Sq * k.shape[2]
        return 4 * hd * pairs * B * H, nbytes
    if name == "ssd_scan":
        x, _, b, c, chunk = args[:5]
        B, H, L, P = x.shape
        return ssd_flops(B, H, L, P, b.shape[-1], chunk, _shared_bc(b, c)), nbytes
    raise KeyError(name)


OPS = {name: getattr(torch.ops.repro_torch, name)
       for name in ("rmsnorm", "gated_rmsnorm", "flash_attention", "ssd_scan")}


def _formula(name):
    def flops(*args, out_val=None, **kw):
        return work(name, args, out_val)[0]

    return flops


for _name, _op in OPS.items():
    register_flop_formula(_op, get_raw=True)(_formula(_name))
