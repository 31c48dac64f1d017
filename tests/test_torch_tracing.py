"""The port's spans (``repro_torch.tracing``): free with no profiler
running, and under ``torch.profiler.profile`` (CPU) each ``mmfl.*`` name of
the module's table appears, as often and in the order the round loop's work
says, none inside another, with results bit-equal to an unprofiled run.
Every backend's ``run_cohort`` and every rule's fold entry points record
their span once a call.

The sync run is the tiny two-task spec with smollm at tau 2 on ``vmap``
under ``fedavg`` (so it folds), two rounds; the async run is the same spec
at tau 1, 9 arrivals in buffers of 3."""
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro_torch import tracing
from repro_torch.api.aggregator import AGGREGATORS, get_aggregator
from repro_torch.api.backend import ShardedBackend
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SPEC = str(ROOT / "examples" / "specs" / "tiny_two_task.json")
TAU = 2
SPANS = ("mmfl.allocate", "mmfl.batch", "mmfl.cohort", "mmfl.fold", "mmfl.eval")


class Span(NamedTuple):
    name: str
    start: int          # ns, the profiler's clock
    end: int
    thread: int


def _spec(mode="sync"):
    spec = tapi.ScenarioSpec.load(SPEC)
    rt = spec.runtime
    rt.mode, rt.backend, rt.aggregator = mode, "vmap", "fedavg"
    if mode == "sync":
        spec.tasks[0].options["tau"] = rt.tau = TAU
    else:
        rt.total_arrivals, rt.buffer_size = 9, 3
    return spec


def _run(mode="sync"):
    return tapi.run_scenario(_spec(mode), device="cpu")


def _traced(fn):
    """``fn()`` under the profiler, and the ``mmfl.*`` events it recorded
    as ``Span``s in the order they start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("mmfl.")]
    return out, sorted(evs, key=lambda e: e.start)


def _profiled(mode="sync"):
    """A run under the profiler, and its ``mmfl.*`` events."""
    return _traced(lambda: _run(mode))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plain(one_thread):
    return _run()


@pytest.fixture(scope="module")
def profiled(one_thread):
    return _profiled()


def _assert_same(a, b):
    np.testing.assert_array_equal(a.loss, b.loss)
    np.testing.assert_array_equal(a.alloc, b.alloc)
    np.testing.assert_array_equal(a.acc, b.acc)
    for pa, pb in zip(a.params, b.params):
        for la, lb in zip(tree_leaves(pa), tree_leaves(pb)):
            assert torch.equal(la, lb)


def _inside(child, parents):
    """The profiler event of ``parents`` that holds ``child``, or None."""
    for p in parents:
        if p.thread == child.thread and p.start <= child.start and child.end <= p.end:
            return p
    return None


def _named(evs, name):
    return [e for e in evs if e.name == name]


def test_a_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("mmfl.batch") is tracing.span("mmfl.cohort")
    with tracing.span("mmfl.batch"):
        pass


def test_tracing_off_never_builds_a_record_function(monkeypatch, plain):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _assert_same(_run(), plain)


def test_profiled_results_are_bit_equal(plain, profiled):
    _assert_same(profiled[0], plain)


def test_every_span_appears(profiled):
    assert {e.name for e in profiled[1]} == set(SPANS)


def test_span_counts(profiled):
    res, evs = profiled
    counts = np.asarray(res.alloc_counts)           # (rounds, tasks); smollm is tau 2
    rounds, given = len(counts), int((counts > 0).sum())
    folds = int((counts[:, 0] > 0).sum())
    assert rounds == 2 and folds >= 1
    assert len(_named(evs, "mmfl.allocate")) == rounds
    assert len(_named(evs, "mmfl.batch")) == len(_named(evs, "mmfl.cohort")) == given
    assert len(_named(evs, "mmfl.fold")) == folds
    assert len(_named(evs, "mmfl.eval")) == rounds * len(res.task_names)


def test_spans_follow_the_round(profiled):
    """A round: the allocation; each task given clients, its batch and
    cohort (and fold, for the tau 2 task); each task's eval probe."""
    res, evs = profiled
    want = []
    for row in np.asarray(res.alloc_counts):
        want.append("mmfl.allocate")
        for s, n in enumerate(row):
            if n > 0:
                want += ["mmfl.batch", "mmfl.cohort"] + (["mmfl.fold"] if s == 0 else [])
        want += ["mmfl.eval"] * len(row)
    assert [e.name for e in evs] == want


@pytest.mark.parametrize("name", SPANS)
def test_spans_nest(profiled, name):
    """No span lies inside another: each marks a layer seam of its own, so
    the readers never count one interval twice."""
    evs = profiled[1]
    for e in _named(evs, name):
        assert _inside(e, [o for o in evs if o is not e]) is None, name


def _cohort_backend(kind):
    if kind.startswith("sharded"):
        return ShardedBackend(device="cpu", mesh=("cpu",) * int(kind[-1]))
    return tapi.get_backend(kind, device="cpu")


@pytest.mark.parametrize("kind", ["serial", "vmap", "sharded1", "sharded2"])
def test_one_cohort_span_per_call(kind):
    """Each backend's ``run_cohort`` records ``mmfl.cohort`` once a call:
    ``sharded`` on one device falls back to ``vmap``'s without a second."""
    state = SimpleNamespace(params={"w": torch.zeros(3)},
                            local_fn=lambda p, keys, x: ({"w": p["w"] + x}, x.sum(1)))
    batch = tapi.ClientBatch(client_ids=np.arange(4), keys=None, data=(torch.ones(4, 3),))
    backend = _cohort_backend(kind)
    res, evs = _traced(lambda: backend.run_cohort(state, batch))
    assert res.updates["w"].shape == (4, 3)
    assert [e.name for e in evs] == ["mmfl.cohort"]


@pytest.mark.parametrize("entry", ["aggregate_params", "aggregate_stale"])
@pytest.mark.parametrize("rule", AGGREGATORS.names())
def test_one_fold_span_per_call(rule, entry):
    """Every rule's fold entry points, base or override, record
    ``mmfl.fold`` once a call."""
    agg = get_aggregator(rule)
    params = {"w": torch.linspace(-1, 1, 6)}
    stacked = {"w": torch.stack([params["w"] + k for k in range(4)])}
    weights = torch.tensor([1.0, 2.0, 3.0, 4.0])
    state = agg.init(params)
    if entry == "aggregate_params":
        call = lambda: agg.aggregate_params(params, stacked, weights, state)  # noqa: E731
    else:
        call = lambda: agg.aggregate_stale(stacked, weights, torch.tensor([0, 1, 0, 2]),  # noqa: E731
                                           0.5, state)
    out, evs = _traced(call)
    assert out[0]["w"].shape == (6,)
    assert [e.name for e in evs] == ["mmfl.fold"]


def test_async_run_records_its_spans(one_thread):
    res, evs = _profiled("async")
    assert len(res.time) >= 1
    names = {e.name for e in evs}
    assert {"mmfl.batch", "mmfl.cohort", "mmfl.fold", "mmfl.eval", "mmfl.allocate"} <= names
    assert len(_named(evs, "mmfl.fold")) == len(res.time)
