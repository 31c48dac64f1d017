"""``batch_idle_pct.train``: see ``perfbench.harness.program_spans.batch_idle_pct``."""

from perfbench.harness.program_spans import batch_idle_pct as read  # noqa: F401

UNIT = "%"
