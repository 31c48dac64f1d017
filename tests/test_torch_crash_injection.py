"""Kill the port's checkpoint writer at every durable write point and
prove recovery.

``FaultyFS`` below patches ``repro_torch.checkpoint.checkpoint``'s
``_os_write/_os_fsync/_os_replace/_os_rename`` seam (the harness in
``tests/conftest.py`` patches the JAX package's module only). A "kill" is
an exception raised inside one syscall, after half the bytes landed for a
write, which is the torn state a SIGKILL leaves. Swept over op indices:

* the manager (every op): resume lands on the highest step whose
  STEP.json landed, with exactly the records that step committed, and
  the recovered directory takes the next append and save;
* the engines: a run of the async engine, of the sync trainer and of the
  arch sync engine killed at one op of each write class (its last
  occurrence, so the resume replays a real tail) and resumed equals the
  uninterrupted run.
"""
import os

import numpy as np
import pytest
import torch

import repro_torch.checkpoint.checkpoint as ckpt_mod
from repro_torch.api import ClientPopulationSpec, RuntimeSpec, ScenarioSpec, TaskSpec, run_scenario
from repro_torch.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes on a shared CPU, where each process's full thread pool
    oversubscribes the cores and these small runs spin rather than
    compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FaultyFS:
    """Fault injection over the port's checkpoint write seam. Every call
    is recorded as an ``(op, path)`` label in ``ops``; ``arm(i)`` makes
    the i-th op of the next run raise ``Fault`` (a write lands half its
    bytes first). Not an OSError, so no recovery path can swallow it."""

    class Fault(Exception):
        pass

    def __init__(self, monkeypatch):
        self._real = {n: getattr(ckpt_mod, n)
                      for n in ("_os_write", "_os_fsync", "_os_replace", "_os_rename")}
        self.ops = []
        self._arm_at = None
        monkeypatch.setattr(ckpt_mod, "_os_write", self._write)
        monkeypatch.setattr(ckpt_mod, "_os_fsync", self._fsync)
        monkeypatch.setattr(ckpt_mod, "_os_replace", self._replace)
        monkeypatch.setattr(ckpt_mod, "_os_rename", self._rename)

    def arm(self, index):
        self.ops, self._arm_at = [], index

    def disarm(self):
        self.ops, self._arm_at = [], None

    def dry_run(self, fn):
        self.disarm()
        fn()
        ops, self.ops = self.ops, []
        return ops

    @staticmethod
    def _fd_path(fd):
        try:
            return os.readlink(f"/proc/self/fd/{fd}")
        except OSError:  # pragma: no cover - non-procfs platforms
            return f"<fd {fd}>"

    def _fire(self, label):
        self.ops.append(label)
        return self._arm_at is not None and len(self.ops) - 1 == self._arm_at

    def _write(self, fd, data):
        if self._fire(("write", self._fd_path(fd))):
            if len(data) > 1:
                self._real["_os_write"](fd, bytes(data)[: len(data) // 2])
            raise self.Fault(f"injected at write #{len(self.ops) - 1}")
        return self._real["_os_write"](fd, data)

    def _fsync(self, fd):
        if self._fire(("fsync", self._fd_path(fd))):
            raise self.Fault(f"injected at fsync #{len(self.ops) - 1}")
        return self._real["_os_fsync"](fd)

    def _replace(self, src, dst):
        if self._fire(("replace", str(dst))):
            raise self.Fault(f"injected at replace #{len(self.ops) - 1}")
        return self._real["_os_replace"](src, dst)

    def _rename(self, src, dst):
        if self._fire(("rename", str(dst))):
            raise self.Fault(f"injected at rename #{len(self.ops) - 1}")
        return self._real["_os_rename"](src, dst)


@pytest.fixture
def faulty_fs(monkeypatch):
    return FaultyFS(monkeypatch)


# --------------------------------------------------------------- manager

def _mgr_records(step):
    return [{"kind": "round", "step": step, "j": j, "x": step + 0.125 * j} for j in range(2)]


def _mgr_script(d):
    """Appends and saves: the step-k save commits the records of 1..k."""
    mgr = CheckpointManager(d, keep=2)
    try:
        for step in (1, 2, 3):
            for rec in _mgr_records(step):
                mgr.append_history(rec)
            mgr.save(step, {"t": {"w": torch.arange(3.0) * step}}, {"c": step},
                     engine_kind="sync")
    finally:
        mgr.close()


def test_manager_kill_at_every_write_point(faulty_fs, tmp_path):
    ops = faulty_fs.dry_run(lambda: _mgr_script(str(tmp_path / "dry")))
    basenames = {(op, os.path.basename(p)) for op, p in ops}
    for cls in (("replace", "STEP.json"), ("replace", "LATEST"), ("write", "history.jsonl"),
                ("fsync", "history.jsonl"), ("write", "MANIFEST.json")):
        assert cls in basenames, cls
    assert any(op == "fsync" and p.endswith("arrays.npz") for op, p in ops)
    assert any(op == "rename" for op, _ in ops)
    for i in range(len(ops)):
        d = str(tmp_path / f"inj{i}")
        faulty_fs.arm(i)
        with pytest.raises(FaultyFS.Fault):
            _mgr_script(d)
        faulty_fs.disarm()
        done = sum(1 for op, p in ops[:i] if op == "replace" and p.endswith("STEP.json"))
        mgr = CheckpointManager(d, keep=2)
        hit = mgr.begin("sync", resume=True)
        if done == 0:
            assert hit is None and mgr.steps() == []
            assert not os.path.exists(mgr.history_path)
        else:
            assert hit.step == done
            assert hit.history == [r for s in range(1, done + 1) for r in _mgr_records(s)]
            assert hit.coordinator == {"c": done}
            np.testing.assert_array_equal(hit.tasks["t"]["w"].numpy(), np.arange(3.0) * done)
            assert os.path.getsize(mgr.history_path) == \
                mgr._step_meta(hit.step)["history_offset"]
            mgr.append_history({"kind": "round", "step": done + 1, "j": 0})
            mgr.save(done + 1, {"t": {"w": torch.arange(3.0)}}, {"c": done + 1},
                     engine_kind="sync")
            assert mgr.latest_step() == done + 1
        mgr.close()


# --------------------------------------------------------------- engines

def _async_spec(d=None, resume=False):
    return ScenarioSpec(
        name="crash-async", seed=0,
        tasks=[TaskSpec("synth-mnist", options={"n_range": [30, 40]}),
               TaskSpec("synth-fmnist", options={"n_range": [30, 40]})],
        clients=ClientPopulationSpec(n_clients=6, speed_profile="bimodal", speed_spread=4.0),
        runtime=RuntimeSpec(mode="async", tau=1, total_arrivals=8, buffer_size=2,
                            aggregator="fedadam", aggregator_options={"lr": 0.1},
                            checkpoint_dir=d, checkpoint_every=2, checkpoint_keep=2,
                            resume=resume))


def _sync_fed_spec(d=None, resume=False):
    return ScenarioSpec(
        name="crash-sync-fed", seed=0,
        tasks=[TaskSpec("synth-mnist", options={"n_range": [30, 40]}),
               TaskSpec("synth-fmnist", options={"n_range": [30, 40]})],
        clients=ClientPopulationSpec(n_clients=6),
        runtime=RuntimeSpec(mode="sync", rounds=4, tau=1, checkpoint_dir=d,
                            checkpoint_every=2, checkpoint_keep=2, resume=resume))


def _arch_sync_spec(d=None, resume=False):
    return ScenarioSpec(
        name="crash-arch-sync",
        tasks=[TaskSpec("smollm-135m", family="arch",
                        options={"preset": "tiny", "seq": 16, "batch": 2, "tau": 1})],
        clients=ClientPopulationSpec(n_clients=4),
        runtime=RuntimeSpec(mode="sync", rounds=2, tau=1, checkpoint_dir=d,
                            checkpoint_every=1, checkpoint_keep=2, resume=resume))


def _equal(a, b):
    keys = (("loss", "acc", "alloc", "alloc_counts", "wall_clock_sim") if a.mode == "sync"
            else ("loss", "acc", "time", "versions", "arrivals", "buffer_sizes",
                  "staleness_mean"))
    for key in keys:
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    if a.mode == "async":
        assert a.assignments == b.assignments


def _class_sweep(faulty_fs, tmp_path, make_spec):
    """Kill a run at the last op of each write class, resume, compare."""
    full = run_scenario(make_spec(), device="cpu")
    ops = faulty_fs.dry_run(lambda: run_scenario(make_spec(str(tmp_path / "dry")),
                                                 device="cpu"))
    last_of = {}
    for i, (op, p) in enumerate(ops):
        last_of[(op, os.path.basename(p))] = i
    assert len(last_of) >= 8                 # every file of the layout
    for i in sorted(last_of.values()):
        d = str(tmp_path / f"i{i}")
        faulty_fs.arm(i)
        with pytest.raises(FaultyFS.Fault):
            run_scenario(make_spec(d), device="cpu")
        faulty_fs.disarm()
        _equal(full, run_scenario(make_spec(d, resume=True), device="cpu"))


@pytest.mark.parametrize("engine", ["async", "sync_fed"])
def test_engine_kill_at_each_write_point(faulty_fs, tmp_path, engine):
    """An async run (fedadam: params, retained versions and server
    moments) and a sync trainer run, killed at each write class."""
    _class_sweep(faulty_fs, tmp_path, _async_spec if engine == "async" else _sync_fed_spec)


def test_arch_sync_engine_kill_at_write_point_classes(faulty_fs, tmp_path):
    """The arch LM sync engine (params and AdamW state), at each write
    class."""
    _class_sweep(faulty_fs, tmp_path, _arch_sync_spec)
