"""``batch_ms.train``: see ``perfbench.harness.program_spans.batch_ms``."""

from perfbench.harness.program_spans import batch_ms as read  # noqa: F401

UNIT = "ms"
