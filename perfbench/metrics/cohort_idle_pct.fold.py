"""``cohort_idle_pct.fold``: see ``perfbench.harness.program_spans.cohort_idle_pct``."""

from perfbench.harness.program_spans import cohort_idle_pct as read  # noqa: F401

UNIT = "%"
