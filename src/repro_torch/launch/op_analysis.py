"""Per-device costs of a traced run: the dry-run's counter of operators.

The port's counterpart of what ``launch/dryrun.py`` takes from the JAX
package's ``launch/hlo_analysis.py``. Torch has no HLO: ``OpCounter`` is a
``TorchDispatchMode`` that reads the operators a run dispatches, on meta
tensors or real ones, and books per device:

* ``flops``: each operator's count by ``torch.utils.flop_counter``'s
  formulas (products, convolutions, attention; elementwise work counts
  0, as there), and each kernel of the port by its own formula
  (``kernels/shapes.py``: its work, not its plain version's);
* ``bytes``: each operator's inputs read once and outputs written once; a
  view, an alias and an empty allocation move none;
* ``collectives``: count and bytes by op, the bytes being each output
  buffer's size, as ``hlo_analysis`` sums result buffers; an all-to-all
  counts once, whatever the process group lowers it to;
* ``peak_bytes``: the most bytes live at once, storages counted from
  their creation to their release (``track`` books what was live before);
* ``kernels``: the port's kernel calls by name;
* ``devices``: the devices of the tensors made, the host's aside, and
  ``host_bytes_max``, the largest floating-point tensor made on the host
  (DTensor's shard arithmetic makes integer ones there).

A loop traced once on meta tensors (``trips.scan``) is booked as many
times as it has trips; ``looped`` is the most trips so booked (0 for
none), and where it is set the peak holds one trip's intermediates. A DTensor operator is not booked itself: the mode returns
``NotImplemented`` to it, so DTensor runs first and the mode sees what it
lowers to, each rank's local operators and collectives with local shapes.
So every count is per device, and work replicated on a mesh axis counts
in full on each device. The operators DTensor runs on fake tensors to
propagate shapes are not booked.

``roofline_terms`` turns the counts into times on the H100 SXM data
sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3 and NVLink 4 at 450 GB/s a
direction, the figures of an NVIDIA H100 80GB HBM3 at 700 W.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import trips
from repro_torch.kernels import shapes

# NVIDIA H100 80GB HBM3 (SXM), 700 W, data sheet
PEAK_FLOPS = 989e12          # dense bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s each direction
DEVICE_BYTES = 80e9          # the card's memory, the bound "fits" is read against

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
# a wait, a wrapper, a host constant lifted as it is
_SKIP = {"wait_tensor", "_wrap_tensor_autograd", "lift_fresh"}
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(items) -> list:
    """The tensors among ``items`` and in their lists and tuples (an
    operator's arguments and results), without a pytree walk: the counter
    runs once per operator."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class OpCounter(TorchDispatchMode):
    """Counts the per-device work of what runs under it (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_count = collections.Counter()
        self.coll_bytes = collections.Counter()
        self.kernels = collections.Counter()
        self.devices = set()
        self.host_max = 0
        self.live = 0
        self.peak = 0
        self.looped = 0
        self._seen = weakref.WeakSet()

    # ------------------------------------------------------------ memory

    def _hold(self, t) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen.add(st)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, n)

    def _release(self, n) -> None:
        self.live -= n

    def track(self, tree) -> None:
        """Book the tensors of ``tree`` (params, optimizer state, batches,
        caches: DTensors by their local shards) as live from now on."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                self._hold(t.to_local() if isinstance(t, DTensor) else t)

    # ------------------------------------------------------------ operators

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not any(isinstance(t, FakeTensor) for t in ins + outs):
            self._book(func, args, kwargs, ins, out, outs)
        return out

    def _book(self, func, args, kwargs, ins, out, outs) -> None:
        name = func._overloadpacket.__name__
        if name in _SKIP:
            return
        for t in outs:
            if t.device.type == "cpu":
                if t.is_floating_point():
                    self.host_max = max(self.host_max, t.numel() * t.element_size())
            else:
                self.devices.add(str(t.device))
            self._hold(t)
        n = trips.factor()          # a loop traced once on meta tensors
        if not n:
            return
        if n > 1:
            self.looped = max(self.looped, n)
        if name in COLLECTIVES:
            op = COLLECTIVES[name]
            self.coll_count[op] += n
            self.coll_bytes[op] += n * sum(t.numel() * t.element_size() for t in outs)
        elif func.namespace == "repro_torch":
            self.kernels[name] += n
            flops, nbytes = shapes.work(name, args, out)
            self.flops += n * flops
            self.bytes += n * nbytes
        else:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += n * formula(*args, **kwargs, out_val=out)
            self.bytes += n * self._moved(func, name, ins, outs)

    @staticmethod
    def _moved(func, name, ins, outs) -> int:
        if func.is_view or name in _NO_WRITE:
            return 0
        try:
            if not name.endswith("_") and ins and any(
                    o.untyped_storage() is ins[0].untyped_storage() for o in outs):
                return 0        # an alias of its input (``_unsafe_view``, ``alias``)
        except (RuntimeError, NotImplementedError):
            pass
        return sum(t.numel() * t.element_size() for t in ins + outs)

    # ------------------------------------------------------------ results

    def collectives(self) -> dict:
        return {"bytes_by_op": dict(self.coll_bytes), "count_by_op": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values())}

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "collectives": self.collectives(),
                "peak_bytes": self.peak, "looped": self.looped, "kernels": dict(self.kernels),
                "devices": sorted(self.devices), "host_bytes_max": self.host_max}


def roofline_terms(flops: float, bytes_accessed: float, collective_bytes: float) -> dict:
    """Seconds of compute, memory and collectives on one H100 (the module's
    figures), the largest as the bottleneck and the step's lower bound."""
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_accessed / HBM_BW,
             "collective_s": collective_bytes / LINK_BW}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    terms["step_time_lower_bound_s"] = max(terms[k] for k in ("compute_s", "memory_s",
                                                              "collective_s"))
    terms["hardware"] = "NVIDIA H100 80GB HBM3, 700 W (data sheet)"
    return terms
