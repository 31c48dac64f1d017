"""The port's spans: ``torch.profiler`` annotations at its layer seams.

    with span("mmfl.cohort"):
        ...

A span is a ``torch.profiler.record_function`` while a profiler runs, and
one shared no-op context otherwise: the guard costs one boolean check,
where ``record_function`` costs some 15 µs a call with no profiler
running. The profiler is the only switch, store, clock and exporter, so
the spans lie on the device trace's clock. Wrap any run in
``torch.profiler.profile`` and they appear among its events.

The spans, and what reads each (the benchmark's metrics are
``perfbench/metrics/<metric>.py``, ``.train`` and ``.fold`` each). A span
comes with its reader: one that nothing reads is left out.

=================  ==========================================  ===============================
span               where                                       read by
=================  ==========================================  ===============================
``mmfl.allocate``  Eq. 4 allocation and the incentive's        ``profile_async.py``
                   ``recruit`` (sync); dispatch (async)
``mmfl.batch``     ``assemble_batch`` (sync);                  ``batch_ms``, ``batch_idle_pct``
                   ``client_batch`` (async flush)
``mmfl.cohort``    each backend's ``run_cohort``, once a call  ``cohort_idle_pct``,
                                                               ``cohort_launches``
``mmfl.fold``      ``aggregate_params``, ``aggregate_stale``:  ``profile_async.py``
                   once a call
``mmfl.eval``      each eval probe (sync); ``evaluate``         ``profile_async.py``
                   after a flush (async)
=================  ==========================================  ===============================
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler annotation named ``name`` while a profiler runs, else a
    no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
