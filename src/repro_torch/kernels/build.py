"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use by ``nvcc`` into a shared library for Hopper (``sm_90a``), which
is then loaded with ``ctypes``. No PyTorch headers are compiled, so a
build takes seconds. Libraries go to ``build/repro_torch_ext/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


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
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, so)
    built = Built(ctypes.CDLL(str(so)), so, seconds, log)
    _LOADED[name] = built
    return built
