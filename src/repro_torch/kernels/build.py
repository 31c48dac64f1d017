"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use by ``nvcc`` into a shared library for Hopper (``sm_90a``), which
is then loaded with ``ctypes``; ``load_all`` starts one ``nvcc`` per
source, all at once. No PyTorch headers are compiled, so a
build takes seconds. Libraries go to ``build/repro_torch_ext/`` at the
root of the checkout, named by a hash of the source, the headers of
``csrc/`` (``hopper.cuh``, which the TMA/wgmma kernels share) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.

Every wrapper launches through ``launch``: it makes the tensor's device
current where it is not, reads that device's current stream, calls the
kernel's C entry point ``<name>_launch`` (bound once per process), raises
with the kernel's own error string when the launch fails, and adds one to
``LAUNCHES[name]``. So ``LAUNCHES`` counts kernel launches per kernel
name, where they happen and nowhere else, and a run can show that its
main path went through the kernels. ``device_launches`` counts the device
kernels one wrapper call enqueues (a call may make several),
``graph_kernels`` names them.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# every kernel of the port, by the name of its csrc/<name>.cu
KERNELS = ("fedavg", "fused_aggregate", "flash_attention", "rmsnorm", "gated_rmsnorm",
           "ssd_scan")

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


# name -> (the bound ``<name>_launch``, ``<name>_error_string``)
_ENTRIES: Dict[str, tuple] = {}


def _bind(name: str, argtypes) -> tuple:
    lib = load(name).lib
    fn, err = getattr(lib, f"{name}_launch"), getattr(lib, f"{name}_error_string")
    fn.argtypes, fn.restype = [*argtypes, ctypes.c_void_p], ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    _ENTRIES[name] = (fn, err)
    return fn, err


def launch(name: str, argtypes, device: int, *args) -> None:
    """Launch kernel ``name`` on CUDA device ``device`` (an index): call
    ``<name>_launch(*args, stream)`` of ``csrc/<name>.cu`` (built and bound
    with ``argtypes``, the C types of ``args``, at the first call) on that
    device's current stream, then count the launch in ``LAUNCHES``. The
    device is made current for the call where it is not; a stream of
    another device than the current one is refused by CUDA. Raises
    ``RuntimeError`` with the kernel's error string when the launch fails.

    ``torch._C._cuda_getDevice`` and ``torch._C._cuda_getCurrentRawStream``
    are private accessors (the ones PyTorch's own generated code calls):
    the current device index, and the raw handle of the device's current
    stream, which is ``torch.cuda.current_stream(device).cuda_stream``
    without building a ``Stream`` object (tests/test_torch_launch.py holds
    one against the other, on a side stream too). The current device is
    read on every call rather than cached, since a caller may change it
    (``torch.cuda.set_device``) between two launches."""
    fn, err = _ENTRIES.get(name) or _bind(name, argtypes)
    if device == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: {err(rc).decode()}")
    LAUNCHES[name] += 1


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def _libcuda() -> ctypes.CDLL:
    """libcuda with the signatures ``graph_kernels`` calls; the naming
    calls (CUDA 12.3) are left out where libcuda lacks them."""
    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)
    for fn, args in (("cuGraphGetNodes", [vp, vp, sz]), ("cuGraphNodeGetType", [vp, i]),
                     ("cuGraphKernelNodeGetParams_v2", [vp, vp]),
                     ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), vp]),
                     ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), vp])):
        if hasattr(cu, fn):
            getattr(cu, fn).argtypes, getattr(cu, fn).restype = args, ctypes.c_int
    return cu


def _kernel_name(cu, node) -> str:
    """The (mangled) name of a graph kernel node's function, or "?" where
    libcuda cannot name it (``cuFuncGetName``/``cuKernelGetName`` need
    CUDA 12.3)."""
    params = (ctypes.c_void_p * 16)()           # CUDA_KERNEL_NODE_PARAMS_v2 and spare
    if cu.cuGraphKernelNodeGetParams_v2(node, params) != 0:
        return "?"
    func, kern = params[0], params[7]           # .func, and .kern after 56 bytes
    name = ctypes.c_char_p()
    for getter, handle in (("cuFuncGetName", func), ("cuKernelGetName", kern)):
        if handle and hasattr(cu, getter) and getattr(cu, getter)(
                ctypes.byref(name), ctypes.c_void_p(handle)) == 0 and name.value:
            return name.value.decode(errors="replace")
    return "?"


def graph_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` enqueues on the
    current CUDA device, in capture order: the call is run once, then
    captured once in a CUDA graph (never replayed) whose kernel nodes are
    read through libcuda. A kernel libcuda cannot name is "?"."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        _check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, names = ctypes.c_int(), []
    for node in nodes:
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value == 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(_kernel_name(cu, ctypes.c_void_p(node)))
    return names


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s library (``cuobjdump -sass``, built
    first where needed), to check which instructions its kernels compiled
    to."""
    tool = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(load(name).path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def device_launches(fn) -> int:
    """Kernels one call of ``fn`` enqueues on the current CUDA device,
    counted from a CUDA graph of the call (``graph_kernels``)."""
    return len(graph_kernels(fn))


@dataclass
class Built:
    """A loaded kernel library, with what its build cost and printed
    (``seconds`` is 0.0 and ``log`` empty when an earlier build was
    reused)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


_LOADED: Dict[str, Built] = {}


def nvcc() -> str:
    """The nvcc executable: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return load_all([name])[name]


def load_all(names=KERNELS) -> Dict[str, Built]:
    """Compile every named ``csrc/<name>.cu`` (all of ``KERNELS`` by
    default) that needs it, with one ``nvcc`` per source, all started
    together, then load each (once per process)."""
    started = {}
    for name in names:
        if name in _LOADED or name in started:
            continue
        src = CSRC / f"{name}.cu"
        # the headers of csrc/ (hopper.cuh) are part of every source's build
        parts = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
        digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if so.exists():
            _LOADED[name] = Built(ctypes.CDLL(str(so)), so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, src, tmp, so, time.perf_counter())
    failed = []
    for name, (proc, src, tmp, so, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src}:\n{log}")
            continue
        os.replace(tmp, so)
        _LOADED[name] = Built(ctypes.CDLL(str(so)), so, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}
