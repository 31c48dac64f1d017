"""Reading the profiled rounds: device busy time, device time by kernel
name, and the longest idle gaps of the device by what the host was doing.

Their window is the span from the first ``bench.round`` annotation's start
to the last one's end (whole rounds). Device work is every CUDA event of
the profiler (kernels, copies, sets); its busy time is the union of their
intervals inside the window.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import torch


@dataclass
class Event:
    name: str
    start: float      # seconds, the profiler's clock
    end: float
    device: bool


@dataclass
class Reading:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)     # name -> seconds
    idle_gaps: list = field(default_factory=list)      # [(label, seconds)], longest first


def events(prof) -> list:
    """The profiler's events as ``Event`` (CPU annotations and ops, and the
    device's work)."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        name, on_card = e.name(), e.device_type() == cuda
        # annotations (the harness's spans among them) appear on the
        # device's timeline too: they are no device work
        if on_card and (name.startswith("bench.")
                        or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        out.append(Event(name, start, start + dur, on_card))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(evs: list, top: int = 10) -> Reading:
    rounds = [e for e in evs if not e.device and e.name == "bench.round"]
    if not rounds:
        raise SystemExit("the trace holds no round of the window")
    w0, w1 = min(e.start for e in rounds), max(e.end for e in rounds)
    dev = [e for e in evs if e.device and e.end > w0 and e.start < w1]
    if not dev:
        raise SystemExit("the trace holds no device work in the window")
    ops = collections.Counter()
    for e in dev:
        ops[e.name] += min(e.end, w1) - max(e.start, w0)
    busy = _merge([(max(e.start, w0), min(e.end, w1)) for e in dev])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in evs if not e.device and e.end > w0 and e.start < w1]
    labelled = [(_label(host, (a + b) / 2), b - a) for a, b in gaps[:top]]
    return Reading(window_s=w1 - w0, busy_s=sum(e - s for s, e in busy),
                   device_ops=dict(ops.most_common(top)), idle_gaps=labelled)


def _label(host: list, t: float) -> str:
    """What the host was doing at ``t``: the innermost harness span and the
    innermost operation around it."""
    around = [e for e in host if e.start <= t <= e.end]
    spans = [e for e in around if e.name.startswith("bench.")]
    ops = [e for e in around if not e.name.startswith("bench.")]
    span = min(spans, key=lambda e: e.end - e.start).name[6:] if spans else "none"
    op = min(ops, key=lambda e: e.end - e.start).name if ops else "python"
    return f"{span}: {op}"


def kernels(evs: list, stem: str) -> set:
    """The device kernels whose name holds ``stem`` (the trace names a
    kernel by its demangled signature, or its mangled symbol)."""
    return {e.name for e in evs if e.device and stem in e.name}


def kernel_seconds(evs: list, stem: str) -> float:
    """Device seconds of the kernels whose name holds ``stem``."""
    return sum(e.end - e.start for e in evs if e.device and stem in e.name)
