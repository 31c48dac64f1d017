"""Loops over time, and their trip counts on meta tensors.

``scan`` runs a cell over a sequence step by step. On meta tensors (a
shape-only run: ``launch/dryrun.py``) its body, which has the same shapes
at every trip, is traced once and booked ``n`` times by a counter that
reads ``factor()`` (``launch/op_analysis.OpCounter``), as the JAX
package's HLO walker multiplies a ``while`` body by its trip count; a
trace of every step would take minutes at 32k positions. Its backward,
where autograd records the loop, is booked ``n`` times too. The memory
such a counter sees is one trip's intermediates, not the ``n`` trips'
that autograd keeps on a real device (the dry-run's record says so:
``memory.loop_traced_once``).
"""

from __future__ import annotations

import contextlib

import torch

_FACTOR = [1]


def factor() -> int:
    """How many times an operator dispatched now is booked."""
    return _FACTOR[-1]


def scan(cell, xs, consts, carry) -> tuple:
    """``carry = cell(xs[:, t], *consts, *carry)`` for every t along dim 1
    of ``xs``. Returns (``carry[0]`` of every step stacked along dim 1, the
    last carry). On meta tensors one step, booked as ``xs.shape[1]``
    trips (``repeated``), and the stack is its result repeated."""
    L = xs.shape[1]
    if xs.device.type == "meta" and L > 1:
        # every trip after the first carries a state that autograd records
        carry = tuple(t.detach().requires_grad_(xs.requires_grad) for t in carry)
        last = repeated(cell, L, xs[:, 0], *consts, *carry)
        y = last[0][:, None]
        return y.expand(y.shape[0], L, *y.shape[2:]).contiguous(), last
    ys = []
    for t in range(L):
        carry = tuple(cell(xs[:, t], *consts, *carry))
        ys.append(carry[0])
    return torch.stack(ys, dim=1), carry


@contextlib.contextmanager
def trips(n: int):
    """Book what runs inside ``n`` times (nested counts multiply)."""
    _FACTOR.append(_FACTOR[-1] * n)
    try:
        yield
    finally:
        _FACTOR.pop()


class _Repeated(torch.autograd.Function):
    """``body`` once, booked ``n`` times; its backward recomputes the body
    (booked 0 times) and books its vector-Jacobian product ``n`` times."""

    @staticmethod
    def forward(ctx, body, n, *inputs):
        ctx.body, ctx.n = body, n
        ctx.save_for_backward(*inputs)
        with trips(n):
            return tuple(body(*inputs))

    @staticmethod
    def backward(ctx, *gouts):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            with trips(0):
                outs = ctx.body(*inputs)
            with trips(ctx.n):
                grads = iter(torch.autograd.grad(outs, wrt, gouts, allow_unused=True))
        return (None, None, *(next(grads) if t.requires_grad else None for t in inputs))


def repeated(body, n: int, *inputs) -> tuple:
    """``body(*inputs)`` (a tuple of tensors), booked as ``n`` trips of a
    loop, its backward too where autograd records it. Only for meta
    inputs: the values of one trip are not those of ``n``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _Repeated.apply(body, n, *inputs)
    with trips(n):
        return tuple(body(*inputs))
