"""Reading the program's ``mmfl.*`` spans from synthetic events: a span's
host time a round, the device's idle time inside it, and the launches that
start inside it, over the profiled rounds."""

import pytest

from perfbench.harness import program_spans as ps
from perfbench.harness.readers import device_idle_pct
from perfbench.harness.trace import Event, read

ROUNDS = [(0.0, 1.0), (1.0, 2.0)]


def _events(rounds=ROUNDS):
    return [Event("bench.round", a, b, False) for a, b in rounds] + [
        # the first batch straddles the window's start, the second cohort its end
        Event("mmfl.batch", -0.5, 0.3, False),
        Event("mmfl.batch", 1.0, 1.2, False),
        Event("mmfl.cohort", 0.3, 0.9, False),
        Event("mmfl.cohort", 1.25, 2.4, False),
        Event("aten::mm", 0.35, 0.4, False),
        # busy: [0.1, 0.2] [0.5, 0.7] [0.8, 1.1] [1.3, 1.6]
        Event("gemm", 0.1, 0.2, True),
        Event("gemm", 0.5, 0.7, True),
        Event("Memcpy HtoD", 0.8, 1.1, True),
        Event("gemm", 1.3, 1.5, True),
        Event("gemm", 1.45, 1.6, True),
        # two launches at once: the caller's thread and autograd's
        Event("cudaLaunchKernel", 0.35, 0.36, False),
        Event("cudaLaunchKernel", 0.35, 0.37, False),
        Event("cuLaunchKernel", 1.5, 1.51, False),
        Event("cudaGraphLaunch", 1.9, 1.95, False),
        Event("cudaLaunchKernel", 0.29, 0.31, False),      # starts in the batch
        Event("cudaLaunchKernelExC", 2.1, 2.2, False),     # after the window
        Event("cudaMemcpyAsync", 0.4, 0.41, False),        # no launch
    ]


def _ctx(evs):
    return {"events": evs, "trace": read(evs)}


def test_span_ms_cuts_spans_to_the_window():
    # batch [0, 0.3] + [1.0, 1.2] over 2 rounds
    assert ps.batch_ms(_ctx(_events())) == pytest.approx(1e3 * 0.5 / 2)


def test_idle_inside_a_span_by_hand():
    ctx = _ctx(_events())
    # idle [0, 0.1] [0.2, 0.5] [0.7, 0.8] [1.1, 1.3] [1.6, 2.0]
    # batch: [0, 0.1] + [0.2, 0.3] + [1.1, 1.2]
    assert ps.batch_idle_pct(ctx) == pytest.approx(100 * 0.3 / 2.0)
    # cohort: [0.3, 0.5] + [0.7, 0.8] + [1.25, 1.3] + [1.6, 2.0]
    assert ps.cohort_idle_pct(ctx) == pytest.approx(100 * 0.75 / 2.0)
    assert device_idle_pct(ctx) == pytest.approx(100 * 1.1 / 2.0)
    assert ps.batch_idle_pct(ctx) + ps.cohort_idle_pct(ctx) <= device_idle_pct(ctx)


def test_launches_by_start_from_two_threads():
    # 0.35 twice, 1.5 and 1.9 over 2 rounds
    assert ps.cohort_launches(_ctx(_events())) == pytest.approx(4 / 2)


def test_per_round_quantities_divide_by_the_rounds():
    quarters = [(0.0, 0.5), (0.5, 1.0), (1.0, 1.5), (1.5, 2.0)]
    two, four = _ctx(_events()), _ctx(_events(quarters))
    assert ps.batch_ms(four) == pytest.approx(ps.batch_ms(two) / 2)
    assert ps.cohort_launches(four) == pytest.approx(ps.cohort_launches(two) / 2)
    assert ps.cohort_idle_pct(four) == pytest.approx(ps.cohort_idle_pct(two))


@pytest.mark.parametrize("reader", [ps.batch_ms, ps.batch_idle_pct, ps.cohort_idle_pct,
                                    ps.cohort_launches])
def test_nothing_without_program_spans(reader):
    evs = [e for e in _events() if not e.name.startswith("mmfl.")]
    assert reader(_ctx(evs)) is None
    assert reader({"events": None, "trace": None}) is None
