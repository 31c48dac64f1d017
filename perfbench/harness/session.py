"""One run of a cell through the port: set-up, the warm rounds that the
correctness check reads, the measured window, and the program's state
freed.

The harness builds the port's ``arch`` tasks (``ArchFamily.build_tasks``,
each cut in depth by ``DepthCut``), copies its own seeded weights into
their params, and drives ``ArchSyncEngine.run``: the sync round loop of
the system's main path. It never edits the program: it wraps methods of
the engine instance it built (the coordinator's ``next_round`` and
``report``, the backend's ``run_cohort``, the aggregator's
``aggregate_params``, the eval probes) and the API object each task's
eval probe calls. The first ``warm_rounds`` rounds are set-up; the window
then runs whole rounds until ``seconds`` have passed and ends at a round
boundary, after a ``torch.cuda.synchronize()``.

A traced run times the window as an untraced one does, with host-clock
spans around the layers' calls (each ends in a synchronise), and then
runs whole rounds under ``torch.profiler`` for ``seconds / 2`` more, at
least two: the profiler's cost per operation (it doubles a round of many
small launches) stays out of the window's time, and so out of ``mfu`` and
the spans; the device's busy time, the kernels' rooflines and the
breakdown come from the profiled rounds.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import time

import torch

from perfbench.harness import arith
from perfbench.harness.cell import DepthCut
from perfbench.reference import mmfl
from perfbench.reference.common import ModelConfig, leaves


class WindowClosed(Exception):
    """Raised at the first round boundary after the window's time."""


class Session:
    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, started: float):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.started = started
        self.tasks = cell.tasks()
        self.names = [t["arch"] for t in self.tasks]
        warm = cell.warm_rounds
        n = len(self.tasks)
        self.readings = {"alloc": [], "loss": [[None] * n for _ in range(warm)],
                         "probe": [[None] * n for _ in range(warm)],
                         "first_grad": [None] * n, "change": [None] * n}
        self.rounds_started = 0
        self.in_window = False
        self.window = collections.Counter()
        self.spans = collections.Counter()
        self.bytes = collections.Counter()
        self.profiler = None
        self.profiling = False
        self.traced_rounds = 0
        self._round_span = None
        self.cuda = self.device.type == "cuda"
        self.marks = {}      # set-up's steps: seconds since the process started

    # ------------------------------------------------------------ build

    def build(self):
        from repro_torch.api import (AllocationSpec, ClientPopulationSpec, RuntimeSpec,
                                     ScenarioSpec, TaskSpec)
        from repro_torch.api.engine import ArchFamily, ArchSyncEngine

        sc = self.cell.scenario
        spec = ScenarioSpec(
            name=self.cell.name, seed=sc["seed"], data_seed=self.seed,
            tasks=[TaskSpec(t["arch"], family="arch",
                            options=dict(preset=t.get("preset", "full"), seq=t["seq"],
                                         batch=t["batch"], tau=t["tau"], shards=t["shards"]))
                   for t in self.tasks],
            clients=ClientPopulationSpec(n_clients=sc["n_clients"],
                                         participation=sc["participation"]),
            allocation=AllocationSpec(strategy=sc["strategy"], alpha=sc["alpha"]),
            runtime=RuntimeSpec(mode="sync", backend=sc["backend"], rounds=2**62,
                                tau=max(t["tau"] for t in self.tasks),
                                aggregator=sc["aggregator"]))
        self._mark("imports")
        with DepthCut({t["arch"]: t["cfg"].n_layers for t in self.tasks}):
            tasks, data = ArchFamily().build_tasks(spec, self.device)
        self._mark("port_build")
        for s, t in enumerate(self.tasks):
            built = tasks[t["arch"]]
            _same_config(built["cfg"], t["cfg"])
            self._load_weights(s, t["cfg"], built["params"])
            api = built["api"]
            built["api"] = dataclasses.replace(api, prefill_fn=self._probe(s, api.prefill_fn))
        self._mark("weights")
        self.engine = engine = ArchSyncEngine(spec, tasks, data, None, None, self.device)
        self._mark("engine")
        coord = engine.coord
        coord.next_round = self._next_round(coord.next_round)
        coord.report = self._report(coord.report)
        if self.trace:
            self._install_spans()

    def _load_weights(self, s: int, cfg: ModelConfig, params):
        """Copy the harness's weights of task ``s`` into the port's params,
        leaf by leaf (the same paths, shapes and dtypes, or a failure)."""
        want = dict(leaves(mmfl.weights(cfg, mmfl.weight_seed(self.seed, s), self.device)))
        got = dict(leaves(params))
        if want.keys() != got.keys():
            raise SystemExit(f"{cfg.name}: the port's params {sorted(got)} are not the "
                             f"reference's {sorted(want)}")
        with torch.no_grad():
            for path, leaf in got.items():
                w = want.pop(path)
                if w.shape != leaf.shape or w.dtype != leaf.dtype:
                    raise SystemExit(f"{cfg.name}: {path} is {tuple(leaf.shape)} {leaf.dtype} "
                                     f"in the port, {tuple(w.shape)} {w.dtype} here")
                leaf.copy_(w)

    # ------------------------------------------------------------ hooks

    def _probe(self, s: int, prefill):
        def wrapped(params, cfg, batch):
            logits, caches = prefill(params, cfg, batch)
            r = self.rounds_started - 1
            if not self.in_window and r < self.cell.warm_rounds:
                self.readings["probe"][r][s] = logits[:, -1].argmax(-1).tolist()
            return logits, caches

        return wrapped

    def _next_round(self, next_round):
        def wrapped():
            self._boundary()
            alloc = next_round()
            if self.rounds_started <= self.cell.warm_rounds:
                row = [-1] * self.cell.scenario["n_clients"]
                for s, name in enumerate(self.names):
                    for i in alloc[name]:
                        row[int(i)] = s
                self.readings["alloc"].append(row)
            return alloc

        return wrapped

    def _report(self, report):
        def wrapped(task, loss):
            s = self.names.index(task)
            if self.in_window:
                t = self.tasks[s]
                self.window["attempted"] += 1
                self.window["failed"] += not math.isfinite(loss)
                self.window["tokens"] += arith.round_tokens(t["batch"], t["seq"], t["tau"])
                rows = 1 if t["tau"] > 1 else t["batch"]
                steps = t["batch"] * t["tau"] if t["tau"] > 1 else 1
                self.window["flops"] += steps * arith.train_flops(t["cfg"], t["seq"], rows)
            elif self.rounds_started <= self.cell.warm_rounds:
                self.readings["loss"][self.rounds_started - 1][s] = float(loss)
            return report(task, loss)

        return wrapped

    def _boundary(self):
        """The start of a round (and the end of the one before)."""
        r, warm = self.rounds_started, self.cell.warm_rounds
        if 0 < r <= warm:
            self._first_grads()
        if r == warm:
            self._changes()
            self._open_window()
            if self.seconds <= 0:          # the warm rounds alone
                self.t_end, self.in_window = self.t_start, False
                self.peak_bytes = self._peak()
                raise WindowClosed
        elif r > warm:
            self._sync()
            now = time.perf_counter()
            self._close_round()
            if self.in_window:
                self.window["rounds"] += 1
                if now - self.t_start >= self.seconds:
                    self._close_window(now)
            else:
                self.traced_rounds += 1
                if self.traced_rounds >= 2 and now - self.t_traced >= self.seconds / 2:
                    raise WindowClosed
        self.rounds_started += 1
        if self.profiling:
            self._open_round()

    def _first_grads(self):
        """A tau = 1 task's first gradient as AdamW got it (after the clip):
        its first moment after one step over (1 - b1)."""
        for s, t in enumerate(self.tasks):
            opt = self.engine.tasks[t["arch"]]["opt"]
            if t["tau"] <= 1 and self.readings["first_grad"][s] is None and int(opt["count"]) == 1:
                self.readings["first_grad"][s] = {
                    p: v / (1 - mmfl.ADAMW["b1"]) for p, v in mmfl.norms(opt["mu"]).items()}

    def _changes(self):
        """The norm of each leaf's change over the warm rounds."""
        with torch.no_grad():
            for s, t in enumerate(self.tasks):
                p0 = dict(leaves(mmfl.weights(t["cfg"], mmfl.weight_seed(self.seed, s),
                                              self.device)))
                self.readings["change"][s] = {
                    p: float(torch.linalg.vector_norm(leaf.float() - p0.pop(p).float()))
                    for p, leaf in leaves(self.engine.tasks[t["arch"]]["params"])}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def _mark(self, step: str):
        self._sync()
        self.marks[step] = time.perf_counter() - self.started

    def _open_window(self):
        self._mark("warm_rounds")
        self.setup_peak = self._peak()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.perf_counter() - self.started
        self.in_window = True
        self.t_start = time.perf_counter()

    def _close_window(self, now: float):
        """The window's end; a traced run goes on to its profiled rounds."""
        self.t_end = now
        self.in_window = False
        self.peak_bytes = self._peak()
        if not self.trace:
            raise WindowClosed
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=acts)
        self.profiler.start()
        self.profiling = True
        self.t_traced = time.perf_counter()

    def _open_round(self):
        if self.profiler is not None:
            self._round_span = torch.profiler.record_function("bench.round")
            self._round_span.__enter__()

    def _close_round(self):
        if self._round_span is not None:
            self._round_span.__exit__(None, None, None)
            self._round_span = None

    # ------------------------------------------------------------ spans

    def _install_spans(self):
        """Spans around the calls into each layer: in the window on the host
        clock, each starting and ending in a synchronise, so the device work
        a call queued is its own; in the profiled rounds as profiler
        annotations alone, which name the idle gaps. A counter of the bytes
        each call of the fold kernel's wrapper moves in the profiled rounds."""
        import repro_torch.api.backend as backend

        eng = self.engine
        eng.backend.run_cohort = self._span("cohort", eng.backend.run_cohort)
        eng.aggregator.aggregate_params = self._span("fold", eng.aggregator.aggregate_params)
        for a in list(eng._eval_acc):
            eng._eval_acc[a] = self._span("eval", eng._eval_acc[a])
        fedavg = backend.fedavg

        def counted_fedavg(stacked, weights):
            if self.profiling:
                self.bytes["fedavg"] += arith.fedavg_bytes(*stacked.shape, stacked.element_size())
            return fedavg(stacked, weights)

        backend.fedavg = counted_fedavg

    def _span(self, name: str, fn):
        def wrapped(*args, **kw):
            if self.profiling:
                with torch.profiler.record_function(f"bench.{name}"):
                    return fn(*args, **kw)
            if not self.in_window:
                return fn(*args, **kw)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self._sync()
            self.spans[name] += time.perf_counter() - t0
            return out

        return wrapped

    # ------------------------------------------------------------ run

    def run(self):
        """Set-up's warm rounds, the window, and a traced run's profiled
        rounds. Returns the window's seconds."""
        try:
            self.engine.run()
        except WindowClosed:
            pass
        else:
            raise SystemExit("the round loop ended before the window closed")
        if self.profiler is not None:
            self.profiler.stop()
            self.profiling = False
        return self.t_end - self.t_start

    def free(self):
        """Drop the program's state, so the reference starts on an empty card."""
        self.engine = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def _same_config(port_cfg, cfg: ModelConfig):
    """The port builds the model the configuration file states."""
    diff = {f.name: (getattr(port_cfg, f.name), getattr(cfg, f.name))
            for f in dataclasses.fields(cfg) if getattr(port_cfg, f.name) != getattr(cfg, f.name)}
    if diff:
        raise SystemExit(f"{cfg.name}: the port runs another model than the configuration "
                         f"file states (port, file): {diff}")
