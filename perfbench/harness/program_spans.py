"""The program's own spans over the profiled rounds: the ``mmfl.*``
profiler annotations of ``repro_torch/tracing.py``, read from the trace
(``ctx["events"]``, the ``Event`` list of ``harness/trace.py``).

The window and the number of rounds are the ``bench.round`` events', as
``trace.read`` takes them. A span's time is the union of its intervals,
each cut to the window. The device is idle where no kernel, copy or set
runs (the complement of ``trace.read``'s busy time). A launch is a
launch call of the CUDA runtime or of ``libcuda`` in the trace
(``cudaLaunch*``, ``cuLaunch*``, ``cudaGraphLaunch``), counted where it
starts, from any thread: autograd's backward launches from its own device thread, while
the span that waits on it lies on the calling thread. Each quantity is a
round's or the window's; every one is None on a trace without a program
span (a program without them).
"""

from __future__ import annotations

import bisect

from perfbench.harness.trace import _merge

LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


def _window(evs):
    """(start, end, rounds) of the profiled rounds, or None without a
    program span."""
    rounds = [e for e in evs if not e.device and e.name == "bench.round"]
    if not rounds or not any(e.name.startswith("mmfl.") for e in evs):
        return None
    return min(e.start for e in rounds), max(e.end for e in rounds), len(rounds)


def _clipped(intervals, w0, w1):
    return _merge([(max(s, w0), min(e, w1)) for s, e in intervals if e > w0 and s < w1])


def _spans(evs, name, w0, w1):
    return _clipped([(e.start, e.end) for e in evs if not e.device and e.name == name], w0, w1)


def _total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def span_ms(evs, name):
    """Host ms a round inside ``name``."""
    w = _window(evs)
    if w is None:
        return None
    w0, w1, rounds = w
    return 1e3 * _total(_spans(evs, name, w0, w1)) / rounds


def idle_pct(evs, name):
    """Share of the window in which the device was idle while the host was
    inside ``name``."""
    w = _window(evs)
    if w is None:
        return None
    w0, w1, _ = w
    busy = _clipped([(e.start, e.end) for e in evs if e.device], w0, w1)
    idle, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    return 100 * _overlap(idle, _spans(evs, name, w0, w1)) / (w1 - w0)


def launches(evs, name):
    """Launch calls a round that start inside ``name``."""
    w = _window(evs)
    if w is None:
        return None
    w0, w1, rounds = w
    spans = _spans(evs, name, w0, w1)
    starts = [s for s, _ in spans]
    n = 0
    for e in evs:
        if e.name.startswith(LAUNCHES):
            k = bisect.bisect_right(starts, e.start) - 1      # the last span starting before
            if k >= 0 and e.start < spans[k][1]:
                n += 1
    return n / rounds


def _events(ctx):
    return ctx["events"] or []


def batch_ms(ctx):
    """Host ms a round inside ``mmfl.batch``: the round's shard and frame
    draws and their copies to the device."""
    return span_ms(_events(ctx), "mmfl.batch")


def batch_idle_pct(ctx):
    """Share of the profiled rounds in which the device was idle while the
    host was inside ``mmfl.batch``."""
    return idle_pct(_events(ctx), "mmfl.batch")


def cohort_idle_pct(ctx):
    """Share of the profiled rounds in which the device was idle while the
    host was inside ``mmfl.cohort``: the cohorts' launch-bound time."""
    return idle_pct(_events(ctx), "mmfl.cohort")


def cohort_launches(ctx):
    """CUDA launch calls a round that start inside ``mmfl.cohort``."""
    return launches(_events(ctx), "mmfl.cohort")
