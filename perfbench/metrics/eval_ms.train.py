"""``eval_ms.train``: see ``perfbench.harness.readers.eval_ms``."""

from perfbench.harness.readers import eval_ms as read  # noqa: F401

UNIT = "ms"
