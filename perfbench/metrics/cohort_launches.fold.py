"""``cohort_launches.fold``: see ``perfbench.harness.program_spans.cohort_launches``."""

from perfbench.harness.program_spans import cohort_launches as read  # noqa: F401

UNIT = "launches"
