"""``cohort_ms.fold``: see ``perfbench.harness.readers.cohort_ms``."""

from perfbench.harness.readers import cohort_ms as read  # noqa: F401

UNIT = "ms"
