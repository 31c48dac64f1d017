"""Checkpointing on numpy + JSON, in the JAX package's on-disk layout.

The port's counterpart of the JAX package's ``checkpoint/checkpoint.py``.
The files are the same, byte for byte in their layout, so a step written
by either package resumes in the other:

    <dir>/step_<n>/
        STEP.json              # step, task names, coordinator payload,
                               # engine kind, committed sidecar offset
        <task>/MANIFEST.json   # tree structure, dtypes, metadata
        <task>/arrays.npz      # one entry per leaf, keyed by tree path
    <dir>/history.jsonl        # append-only whole-run record sidecar
    <dir>/LATEST               # the newest complete step (for people)

Leaves are written from the host: a tensor on the card is copied once to
host memory at save. Keys are the '/'-joined dict keys and list indices
with '/' written as '|'. numpy has no bfloat16, so a bf16 leaf is stored
as its uint16 bits with ``"bfloat16"`` recorded in the manifest's dtypes.
``load_pytree`` gives CPU tensors of the recorded dtypes (bf16 from its
bits); ``like=`` casts them onto a template's dtypes and devices.

Atomicity, the sidecar and recovery are the reference's:

* A pytree is written to ``<path>.tmp`` and renamed into place; STEP.json
  and LATEST land by write, fsync and rename. STEP.json's existence marks
  a step complete, and ``latest_step`` scans for it (LATEST is not
  trusted).
* Records that grow with run length (the sync round curves, the async
  flush records and dispatch log) stream into ``history.jsonl`` through
  ``append_history``, buffered. ``save`` fsyncs the sidecar first and
  commits its byte offset in STEP.json, so a record is durable exactly
  when a complete step's offset covers it.
* ``begin`` is the engines' one entry point: it restores the newest
  complete step, refuses a step of another engine kind, truncates the
  sidecar to the committed offset and replays the records before it; or,
  when there is nothing to resume, clears stale steps and the sidecar.
  Steps from before the sidecar (history embedded in STEP.json) carry no
  offset: ``begin`` returns ``history=None`` for them and the engines read
  the embedded payload.

Every durable write goes through the module-level ``_os_write``,
``_os_fsync``, ``_os_replace`` and ``_os_rename``, so a test can fail the
process at each write point (``tests/test_torch_crash_injection.py``).
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

# Fault-injection seam: every durable write goes through these.
_os_write = os.write
_os_fsync = os.fsync
_os_replace = os.replace
_os_rename = os.rename

HISTORY_FILE = "history.jsonl"


def _flatten(tree, prefix=""):
    """Yield (path, leaf); dict keys in sorted order, as the reference."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(struct, arrays, prefix=""):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, arrays, f"{prefix}/{k}" if prefix else k)
                for k, v in struct["items"].items()}
    if kind in ("list", "tuple"):
        seq = [_rebuild(v, arrays, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(struct["items"])]
        return tuple(seq) if kind == "tuple" else seq
    return arrays[prefix]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """One leaf as the array that goes into the npz and its dtype name:
    a tensor is copied to the host once; bf16 travels as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        a = t.cpu().numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":               # an ml_dtypes array
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """An npz entry -> a CPU tensor of the recorded dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _write_file(path: str, data: bytes) -> None:
    """Write and fsync ``data`` to ``path`` through the injection seam."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        view = memoryview(data)
        while len(view):
            n = _os_write(fd, view)
            view = view[n:]
        _os_fsync(fd)
    finally:
        os.close(fd)


def save_pytree(path: str, tree, metadata: Optional[Dict[str, Any]] = None) -> None:
    """Atomic save of one pytree (tensors, numpy arrays or Python numbers)
    and its metadata to the directory ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    dtypes, packed = {}, {}
    for k, leaf in _flatten(tree):
        packed[k.replace("/", "|")], dtypes[k] = _host(leaf)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **packed)
        f.flush()
        _os_fsync(f.fileno())
    del packed
    manifest = {"structure": _structure(tree), "dtypes": dtypes, "metadata": metadata or {}}
    _write_file(os.path.join(tmp, "MANIFEST.json"), json.dumps(manifest).encode())
    if os.path.exists(path):
        shutil.rmtree(path)
    _os_rename(tmp, path)


def read_arrays(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """The manifest of a saved pytree and its raw npz entries by tree path
    (bf16 leaves still as their uint16 bits)."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k.replace("|", "/"): z[k] for k in z.files}
    return manifest, arrays


def load_pytree(path: str, like=None):
    """Load a pytree saved by either package's ``save_pytree``: CPU tensors
    of the recorded dtypes, or, with ``like``, each leaf cast onto the
    dtype and device of the template's leaf. Returns (tree, metadata)."""
    manifest, raw = read_arrays(path)
    dtypes = manifest["dtypes"]
    arrays = {k: _tensor(v, dtypes.get(k, str(v.dtype))) for k, v in raw.items()}
    del raw
    tree = _rebuild(manifest["structure"], arrays)
    if like is not None:
        tree = tree_map(lambda t, ref: t.to(device=ref.device, dtype=ref.dtype, copy=True),
                        tree, like)
    return tree, manifest["metadata"]


@dataclass
class ResumeState:
    """What ``CheckpointManager.begin`` hands a resuming engine: the
    restored step, per-task pytrees (CPU tensors), the JSON coordinator
    payload, and the replayed sidecar records up to the committed offset
    (None for a step whose history is embedded in ``coordinator``)."""

    step: int
    tasks: Dict[str, Any]
    coordinator: Dict[str, Any]
    history: Optional[List[dict]]


class CheckpointManager:
    """Multi-task checkpoint manager with retention, LATEST and the
    append-only history sidecar (``history.jsonl``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._hist_fd: Optional[int] = None
        self._hist_pos: Optional[int] = None

    # -- history sidecar ---------------------------------------------------

    @property
    def history_path(self) -> str:
        return os.path.join(self.dir, HISTORY_FILE)

    def _open_history(self) -> int:
        if self._hist_fd is None:
            self._hist_fd = os.open(self.history_path,
                                    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            self._hist_pos = os.fstat(self._hist_fd).st_size
        return self._hist_fd

    def append_history(self, record: dict) -> int:
        """Append one JSON record to the sidecar (buffered: not durable
        until the next ``save`` commits the offset). Returns the offset
        after the append. A kill mid-append leaves a partial line past
        every committed offset, which resume truncates away."""
        fd = self._open_history()
        data = (json.dumps(record, separators=(",", ":")) + "\n").encode()
        view = memoryview(data)
        while len(view):
            n = _os_write(fd, view)
            view = view[n:]
        self._hist_pos += len(data)
        return self._hist_pos

    def history_offset(self) -> int:
        """Byte length of the sidecar, appends not yet committed included
        (what the next ``save`` would commit)."""
        if self._hist_pos is not None:
            return self._hist_pos
        try:
            return os.path.getsize(self.history_path)
        except FileNotFoundError:
            return 0

    def read_history(self, upto: int) -> List[dict]:
        """Parse the committed records: bytes [0, upto)."""
        if upto <= 0:
            return []
        try:
            with open(self.history_path, "rb") as f:
                data = f.read(upto)
        except FileNotFoundError:
            data = b""
        if len(data) < upto:
            raise ValueError(
                f"checkpoint sidecar {self.history_path!r} is shorter "
                f"({len(data)} bytes) than the committed offset {upto}: "
                "the sidecar was truncated or deleted after the step "
                "was written — the run's history cannot be recovered")
        return [json.loads(line) for line in data.splitlines() if line]

    def truncate_history(self, offset: int) -> None:
        """Drop every byte past ``offset``: records appended after the last
        complete ``save`` were never committed, and a resumed run makes
        them again."""
        if self._hist_fd is not None:
            os.close(self._hist_fd)
            self._hist_fd = None
        self._hist_pos = None
        try:
            size = os.path.getsize(self.history_path)
        except FileNotFoundError:
            size = 0
            if offset > 0:
                raise ValueError(
                    f"checkpoint sidecar {self.history_path!r} is missing "
                    f"but step metadata committed offset {offset}")
        if size < offset:
            raise ValueError(
                f"checkpoint sidecar {self.history_path!r} is shorter "
                f"({size} bytes) than the committed offset {offset}")
        if size > offset:
            with open(self.history_path, "r+b") as f:
                f.truncate(offset)
                f.flush()
                _os_fsync(f.fileno())

    def close(self) -> None:
        if getattr(self, "_hist_fd", None) is not None:
            try:
                os.close(self._hist_fd)
            except OSError:
                pass
            self._hist_fd = None
            self._hist_pos = None

    def __del__(self):
        self.close()

    # -- steps -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write_atomic(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        _write_file(tmp, data)
        _os_replace(tmp, path)

    def save(self, step: int, tasks: Dict[str, Any],
             coordinator_state: Optional[Dict[str, Any]] = None,
             engine_kind: Optional[str] = None) -> None:
        """tasks: name -> pytree (e.g. ``{"params": ..., "opt": ...}``).

        With ``engine_kind`` (every engine's save) the step is stamped
        with the writing engine and commits the sidecar: its fd is fsynced
        first, then the offset lands inside STEP.json."""
        sd = self._step_dir(step)
        for name, tree in tasks.items():
            save_pytree(os.path.join(sd, name.replace("/", "_")), tree,
                        metadata={"task": name, "step": step})
        meta = {"step": step, "tasks": sorted(tasks), "coordinator": coordinator_state or {}}
        if engine_kind is not None:
            meta["engine"] = engine_kind
            if self._hist_fd is not None:
                _os_fsync(self._hist_fd)
            meta["history_offset"] = self.history_offset()
        # STEP.json marks the step complete and LATEST points at the
        # newest: both land by tmp + fsync + rename, so a kill mid-write
        # never leaves a present but truncated marker
        self._write_atomic(os.path.join(sd, "STEP.json"), json.dumps(meta).encode())
        self._write_atomic(os.path.join(self.dir, "LATEST"), str(step).encode())
        self._gc()

    def _complete(self, step: int) -> bool:
        return os.path.exists(os.path.join(self._step_dir(step), "STEP.json"))

    def _step_meta(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), "STEP.json")) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        """Newest COMPLETE step: the highest step directory holding a
        STEP.json. LATEST is not trusted: ``save`` lands STEP.json before
        LATEST, and the pointer may also be deleted or dangle."""
        for s in reversed(self.steps()):
            if self._complete(s):
                return s
        return None

    def restore(self, step: Optional[int] = None, like: Optional[Dict[str, Any]] = None):
        """Returns (step, tasks dict, coordinator_state), or None when there
        is no complete step. Task trees are CPU tensors, or cast onto
        ``like[name]`` (a template tree) where given."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        meta = self._step_meta(step)
        tasks = {}
        for name in meta["tasks"]:
            tree, _ = load_pytree(os.path.join(self._step_dir(step), name.replace("/", "_")),
                                  like=(like or {}).get(name))
            tasks[name] = tree
        return step, tasks, meta.get("coordinator", {})

    @staticmethod
    def _saved_kind(meta: Dict[str, Any], coord: Dict[str, Any]) -> str:
        """Which engine wrote this step: the ``engine`` stamp, or for older
        steps inferred from the payload (async nests under ``async``)."""
        kind = meta.get("engine")
        if kind is not None:
            return str(kind)
        return "async" if "async" in coord else "sync"

    def begin(self, engine_kind: str, resume: bool,
              clear_stale: bool = True) -> Optional[ResumeState]:
        """Resume from the newest complete step, or start fresh here.

        Returns a ``ResumeState`` when ``resume`` is set and a complete step
        exists, after refusing a step of another engine kind (resuming it
        would retrain and garbage-collect the other run's steps),
        truncating the sidecar to the committed ``history_offset`` and
        replaying the records before it. Returns ``None`` to start fresh,
        after clearing stale steps and the sidecar (``clear_stale``):
        ``_gc`` assumes increasing steps, and a stale sidecar would
        prepend the old run's records."""
        if resume and self.latest_step() is not None:
            step, tasks, coord = self.restore()
            meta = self._step_meta(step)
            saved = self._saved_kind(meta, coord)
            if saved != engine_kind:
                if engine_kind == "async":
                    raise ValueError(
                        f"cannot resume: checkpoint step {step} in "
                        f"{self.dir!r} carries no async engine state (it "
                        "was written by a different engine); point the "
                        "async run at its own checkpoint directory")
                if saved == "async":
                    raise ValueError(
                        f"cannot resume: checkpoint step {step} in "
                        f"{self.dir!r} was written by the async engine; "
                        "resume it with mode='async' (or point this run "
                        "at its own checkpoint directory)")
                raise ValueError(
                    f"cannot resume: checkpoint step {step} in "
                    f"{self.dir!r} was written by engine kind {saved!r}, "
                    f"not {engine_kind!r}; point this run at its own "
                    "checkpoint directory")
            history = None
            if "history_offset" in meta:
                off = int(meta["history_offset"])
                self.truncate_history(off)
                history = self.read_history(off)
            else:
                # embedded-history step: no offset was committed, so any
                # sidecar content is uncommitted; drop it before the
                # engine backfills, or a later save would commit it twice
                self.truncate_history(0)
            return ResumeState(step, tasks, coord, history)
        if clear_stale and (self.steps() or os.path.exists(self.history_path)):
            self.clear()
        return None

    def steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def clear(self) -> None:
        """Remove every step, LATEST and the sidecar (LATEST first, so a
        kill mid-clear never leaves it pointing at a removed step)."""
        self.close()
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            os.remove(latest)
        for s in self.steps():
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        if os.path.exists(self.history_path):
            os.remove(self.history_path)

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def to_device(tree, device):
    """A restored tree on the engine's ``device``, in tensors of torch's own
    allocation (copied even on the CPU: an array read from the npz may sit
    at another alignment, and the CPU's matmuls may then round
    differently from an uninterrupted run)."""
    return tree_map(lambda t: t.to(device, copy=True), tree)

