"""Partition rules: parameter, cache and batch specs, as DTensor placements.

The port's counterpart of the JAX package's ``sharding/partition.py``,
with the same rules:

  * mesh ('data', 'model') single pod; ('pod', 'data', 'model') multi-pod
  * params: FSDP over 'data' on the d_model-ish axis, TP over 'model' on
    heads/ffn/vocab/experts; replicated over 'pod' (pods are pure DP)
  * activations: batch over ('pod', 'data'); optional Megatron-style
    sequence sharding over 'model' at layer boundaries
  * every rule is divisibility-checked: a dim that does not divide its
    mesh axis is replicated (e.g. qwen3's 8 kv heads on the 16-way model
    axis)

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of names (``P``; a one-name tuple is the name, as JAX's
``PartitionSpec`` reads it). ``placements(mesh, spec)`` turns it into one
``Shard``/``Replicate`` per dim of a ``torch.distributed`` ``DeviceMesh``,
and ``distribute_tree`` lays a param tree out on the mesh, the counterpart
of ``jax.device_put`` with ``NamedSharding``s. A mesh here is anything
with ``mesh_dim_names`` and ``shape``.

``constrain`` is the context the model code reads at layer boundaries:
the caller registers ``(mesh, spec)`` pairs for 'activation' and
'logits'; with no entry, or on a plain tensor, it returns its input.
``use_mesh`` sets the axis sizes and lets the plain tensors the models
make themselves (positions, RoPE tables) meet DTensors as replicated ones.

``on_local_shards`` runs a kernel wrapper on the local shards of DTensor
inputs: the wrappers launch ctypes kernels on raw pointers, which a
DTensor does not have; so do the model's loops and reshapes of split
dims that DTensor has no rule for. ``split_heads``/``merge_heads`` split
a projection into heads at any mesh, ``gather_seq`` keeps the sequence
whole inside a block, and ``distribute_caches``/``write_slot`` lay out
and write decode caches.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

# ------------------------------------------------------------- constrain ctx

_CTX: dict = {}


def set_sharding_ctx(**kw):
    _CTX.update(kw)


def clear_sharding_ctx():
    _CTX.clear()


def P(*entries) -> tuple:
    """A spec: one entry per tensor dim (a one-name tuple becomes the name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _names(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def constrain(x, kind: str):
    """Sharding hint that drops the axes that do not divide their dim."""
    sh = _CTX.get(kind)
    if sh is None or not isinstance(x, DTensor):
        return x
    mesh, spec = sh
    if len(spec) != x.ndim:
        return x
    sizes = _sizes(mesh)
    kept = []
    for dim, names in zip(x.shape, spec):
        if names is None:
            kept.append(None)
            continue
        size = math.prod(sizes[n] for n in _names(names))
        kept.append(names if dim % size == 0 and dim > 1 else None)
    return x.redistribute(mesh, placements(mesh, P(*kept)))


# ------------------------------------------------------------- param rules

STACKED_KEYS = {"dense_layers", "moe_layers", "layers", "enc_layers",
                "dec_layers", "mlstm_layers", "slstm_layers", "lora"}

# 2-D weights whose FIRST dim is the "wide" (tp) dim (projections back to d)
_OUT_PROJ = {"wo", "down", "out_proj", "fc2", "ff_down"}
# 2-D weights (d_in, d_out): fsdp on in, tp on out
_IN_PROJ = {"wq", "wk", "wv", "gate", "up", "in_proj", "fc1", "wx",
            "ff_gate", "ff_up", "wkv_a", "wkv_b", "head", "wif"}


def _axis(dim: int, name: str, sizes: dict) -> Optional[str]:
    """Return the axis name if it divides dim, else None (replicate)."""
    return name if name in sizes and dim % sizes[name] == 0 else None


def _spec_2d(name, shape, sizes):
    a, b = shape
    if name in _OUT_PROJ or name == "tok":
        return P(_axis(a, "model", sizes), _axis(b, "data", sizes))
    if name == "router":
        return P(_axis(a, "data", sizes), None)
    if name == "conv_w":
        return P(None, _axis(b, "model", sizes))
    # _IN_PROJ and every other 2-D weight: (in, out) orientation
    return P(_axis(a, "data", sizes), _axis(b, "model", sizes))


def _spec_3d(name, shape, sizes, expert_parallel):
    E, a, b = shape
    # stacked experts (E, d, f) / (E, f, d)
    ep = _axis(E, "model", sizes) if expert_parallel else None
    if name == "down":
        return P(ep, None if ep else _axis(a, "model", sizes), _axis(b, "data", sizes))
    return P(ep, _axis(a, "data", sizes), None if ep else _axis(b, "model", sizes))


def param_spec(path: tuple, leaf, cfg=None) -> tuple:
    """The spec of one parameter leaf given its tree path (its keys)."""
    sizes = _CTX.get("axis_sizes", {})
    keys = [str(k) for k in path]
    name = keys[-1]
    shape = tuple(leaf.shape)
    stacked = keys[0] in STACKED_KEYS or (len(keys) > 1 and keys[1] in STACKED_KEYS)
    if stacked and len(shape) >= 1:
        inner = shape[1:]
        if len(inner) == 0:
            return P(None)
        if len(inner) == 1:
            return P(None, None)
        if len(inner) == 2:
            return P(None, *_spec_2d(name, inner, sizes))
        if len(inner) == 3:
            ep = bool(cfg) and cfg.n_experts > 0 and inner[0] % sizes.get("model", 1) == 0
            return P(None, *_spec_3d(name, inner, sizes, ep))
        return P(*((None,) * len(shape)))
    if len(shape) <= 1:
        return P(*((None,) * len(shape)))
    if len(shape) == 2:
        return _spec_2d(name, shape, sizes)
    if len(shape) == 3:
        ep = bool(cfg) and cfg.n_experts > 0 and shape[0] % sizes.get("model", 1) == 0
        return _spec_3d(name, shape, sizes, ep)
    return P(*((None,) * len(shape)))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the specs
    it returns are tuples, so they stay leaves of the result."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_param_specs(params, cfg=None):
    return _map_with_path(lambda p, x: param_spec(p, x, cfg), params)


def set_axis_sizes(mesh):
    _CTX["axis_sizes"] = _sizes(mesh)


def dp_axes(mesh):
    """Batch ('data-parallel') axes: ('pod', 'data') when pod exists."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def batch_spec(mesh, batch_size: int, ndim: int) -> tuple:
    dp = dp_axes(mesh)
    sizes = _sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    first = dp if batch_size % dp_size == 0 and batch_size > 1 else None
    return P(first, *([None] * (ndim - 1)))


def cache_spec(path: tuple, leaf, mesh, batch_size: int) -> tuple:
    """KV/SSM cache sharding: batch over dp if divisible; kv-heads or
    head_dim (or seq for big batch=1 caches) over model."""
    sizes = _sizes(mesh)
    tp = sizes.get("model", 1)
    dp = dp_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    name = str(path[-1])
    shape = tuple(leaf.shape)
    bdim = 1 if len(shape) > 1 else None       # caches stacked (L, B, ...)
    spec = [None] * len(shape)
    if name == "positions":
        return P(*spec)
    if bdim is not None and shape[bdim] % dp_size == 0 and shape[bdim] > 1:
        spec[bdim] = dp
    if name in ("k", "v"):                     # (L,B,S,KV,hd)
        if shape[-2] % tp == 0:
            spec[-2] = "model"
        elif shape[-1] % tp == 0:
            spec[-1] = "model"
    elif name in ("c_kv", "k_rope"):           # (L,B,S,r) MLA latent cache
        # mla_cache_shard: 'latent' -> the scores are summed over the model
        # axis each step; 'seq' -> flash-decode style partial softmax per
        # shard
        mode = _CTX.get("mla_cache_shard", "latent")
        if mode == "latent" and shape[-1] % tp == 0:
            spec[-1] = "model"
        elif mode == "seq" and len(shape) >= 3 and shape[-2] % tp == 0 and shape[-2] > 1:
            spec[-2] = "model"
    elif name == "conv":                       # (L,B,k,ch) ssm conv tail
        if shape[-1] % tp == 0:
            spec[-1] = "model"
    elif name == "state":                      # (L,B,1,H,N,P) ssm state
        if len(shape) >= 3 and shape[3] % tp == 0:
            spec[3] = "model"
    elif name in ("h", "c", "n", "m"):         # slstm (G,B,d)
        if shape[-1] % tp == 0:
            spec[-1] = "model"
    return P(*spec)


# ------------------------------------------------------- DTensor layouts

def placements(mesh, spec) -> list:
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim for ``spec``. A
    tensor dim split over several mesh axes shards in mesh-axis order;
    a spec that names them in another order, names an axis twice, or
    names an axis the mesh lacks raises ``ValueError``."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _names(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"placements: spec {spec} names {missing}, not axes of the mesh "
                             f"{names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: spec {spec} splits dim {d} over {axes}, out of the "
                             f"mesh's axis order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"placements: spec {spec} names the axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out


def distribute_tree(tree, specs, mesh):
    """Lay each leaf of ``tree`` out on ``mesh`` by its spec in ``specs``
    (the tree ``tree_param_specs`` returns)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh) for v, s in zip(tree, specs))
    return distribute_tensor(tree, mesh, placements(mesh, specs))


def distribute_caches(caches, mesh, batch_size: int):
    """Lay a decode cache tree out on ``mesh`` by ``cache_spec``: DTensor
    leaves (a prefill's) are redistributed, plain ones distributed; a None
    leaf (xLSTM without sLSTM groups) stays None."""
    def one(path, t):
        if t is None:
            return None
        pl = placements(mesh, cache_spec(path, t, mesh, batch_size))
        return t.redistribute(mesh, pl) if isinstance(t, DTensor) else distribute_tensor(
            t, mesh, pl)

    return _map_with_path(one, caches)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run model code on DTensors of ``mesh``: the axis sizes are set for
    the spec rules, and plain tensors meet DTensors as replicated ones.
    The sharding context is cleared on exit."""
    from torch.distributed.tensor.experimental import implicit_replication

    set_axis_sizes(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        clear_sharding_ctx()


def gather_seq(x):
    """A DTensor (B, S, ...) whose sequence dim is split (the 'seq'
    activation constraint) made whole on those mesh dims; anything else
    as it is. Each block starts with it and the norms end with it, so the
    sequence is split only between blocks, as in sequence parallelism:
    DTensor on torch 2.11 cannot fold a split sequence into a matmul's
    rows, forward (the projections) or backward (the gradient of a
    branch that joins the residual stream)."""
    if not isinstance(x, DTensor) or x.ndim < 3:
        return x
    pl = [Replicate() if p == Shard(1) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def split_heads(x, heads: int, head_dim: int):
    """``x.reshape(*x.shape[:-1], heads, head_dim)``, the head split of a
    projection, at every mesh: a DTensor whose last dim is split over mesh
    axes keeps the split (by heads) where ``heads`` divides the product of
    their sizes, and is made whole on them first otherwise (qwen3's 8 kv
    heads on a 16-way model axis), as XLA reshards such a reshape. On a
    plain tensor, the reshape."""
    shape = (*x.shape[:-1], heads, head_dim)
    if isinstance(x, DTensor):
        last = x.ndim - 1
        on = [j for j, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == last]
        if on and heads % math.prod(x.device_mesh.shape[j] for j in on):
            x = x.redistribute(x.device_mesh, [Replicate() if j in on else p
                                               for j, p in enumerate(x.placements)])
    return x.reshape(shape)


class _MergeHeads(torch.autograd.Function):
    """(..., H, hd) -> (..., H * hd) on a DTensor, whose gradient goes back
    through ``split_heads``: the plain view's backward would unflatten a
    gradient split over the model axis by a head count that does not
    divide it."""

    @staticmethod
    def forward(ctx, x):
        ctx.heads, ctx.head_dim = x.shape[-2:]
        last = x.ndim - 1
        if any(isinstance(p, Shard) and p.dim == last for p in x.placements):
            x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Shard) and
                                               p.dim == last else p for p in x.placements])
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads, ctx.head_dim)


def merge_heads(x):
    """(..., H, hd) -> (..., H * hd), ``split_heads``'s inverse, at every
    mesh; on a plain tensor, the reshape."""
    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def write_slot(t, dim: int, index: int, value) -> None:
    """``t.select(dim, index).copy_(value)`` (or ``.fill_`` for a number),
    in place: a decode step's cache write. On a DTensor ``t`` the rank
    whose shard holds ``index`` writes its part of ``value`` (a DTensor
    laid out as ``t`` less ``dim``) into its local shard; the others
    write nothing."""
    if not isinstance(t, DTensor):
        view = t.select(dim, index)
        view.fill_(value) if isinstance(value, (int, float)) else view.copy_(value)
        return
    mesh = t.device_mesh
    if isinstance(value, DTensor):
        value = value.redistribute(mesh, [
            Shard(p.dim - (p.dim > dim)) if isinstance(p, Shard) and p.dim != dim
            else Replicate() for p in t.placements]).to_local()
    # this rank's part of ``dim``: split in mesh-dim order (cache_spec
    # splits only dims that divide)
    size, start = t.shape[dim], 0
    for j, (p, c) in enumerate(zip(t.placements, mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.shape[j]
            start += c * size
    if not start <= index < start + size:
        return
    view = t._local_tensor.select(dim, index - start)
    view.fill_(value) if isinstance(value, (int, float)) else view.copy_(value)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous. DTensor's
    ``to_local`` backward infers a gradient's global strides from its
    local layout, and gets them wrong where a split dim holds one element
    a rank (one head a rank: qwen1.5-0.5b's 16 heads on the 16-way model
    axis) and the layout is not contiguous (the attention's gradients);
    a later view then fails on the local shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense_grad(t):
    return _DenseGrad.apply(t) if t.requires_grad else t


def on_local_shards(fn, tensors, whole, shared=(), **kw):
    """``fn(*tensors, **kw)`` for a function ``fn`` of plain tensors (a
    kernel wrapper, or a loop DTensor has no rules for) whose inputs
    include DTensors: each DTensor goes to ``fn`` as its local shard, and
    the result (a tensor or a tuple of them) comes back as DTensors.

    ``whole[i]`` is the set of dims of ``tensors[i]`` that ``fn`` reduces
    over, which no shard may split. On each mesh dim the inputs that may
    be split (those with a dim outside ``whole``, and not in ``shared``)
    stay split where all of them are ``Shard`` on the same dim outside
    ``whole``, and that dim divides evenly; otherwise every input is made
    whole (``Replicate``) on that mesh dim, a pending sum (``Partial``)
    included. Inputs whose every dim is in ``whole`` are replicated; their
    gradients are partial sums on the mesh dims the others stay split on.
    The inputs in ``shared`` (indices) are read alike by every part of
    that split (Mamba2's B and C by every head, MLA's RoPE key by every
    head): they keep a split of the kept dim where they are ``Shard`` on
    it and it is outside their ``whole``, and are whole on that mesh dim
    otherwise, their gradients partial sums there. Each result takes the
    placements of the inputs that may be split. Plain tensors among the
    inputs are used as they are; with no DTensor among them this is
    ``fn(*tensors, **kw)``."""
    mesh = next((t.device_mesh for t in tensors if isinstance(t, DTensor)), None)
    if mesh is None:
        return fn(*tensors, **kw)
    cut = [{d % t.ndim for d in w} for t, w in zip(tensors, whole)]
    split = [i for i, t in enumerate(tensors)
             if isinstance(t, DTensor) and len(cut[i]) < t.ndim and i not in shared]
    keep = [None] * mesh.ndim                  # per mesh dim: the tensor dim kept split
    for j in range(mesh.ndim):
        held = [tensors[i].placements[j] for i in split]
        dims = {p.dim for p in held if isinstance(p, Shard)}
        if (not held or len(dims) != 1 or not all(isinstance(p, Shard) for p in held)
                or any(p.dim in cut[i] for i, p in zip(split, held))):
            continue
        d = dims.pop()
        n = math.prod(mesh.shape[k] for k in range(mesh.ndim)
                      if k == j or keep[k] == d)
        if all(tensors[i].shape[d] % n == 0 for i in split):
            keep[j] = d
    out_placements = [Shard(d) if d is not None else Replicate() for d in keep]
    local = []
    for i, t in enumerate(tensors):
        if not isinstance(t, DTensor):
            local.append(t)
        elif i in split:
            local.append(_dense_grad(t.redistribute(mesh, out_placements).to_local()))
        else:
            # used whole, or split alike where shared: a gradient pending sum
            # over the split it is read whole across
            here = [Shard(d) if (i in shared and d is not None and d not in cut[i]
                                 and t.placements[j] == Shard(d)) else Replicate()
                    for j, d in enumerate(keep)]
            grads = [p if isinstance(p, Shard) or d is None else Partial()
                     for p, d in zip(here, keep)]
            local.append(_dense_grad(t.redistribute(mesh, here).to_local(
                grad_placements=grads)))
    out = fn(*local, **kw)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, out_placements, run_check=False) for o in out)
    return DTensor.from_local(out, mesh, out_placements, run_check=False)
