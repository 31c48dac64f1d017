"""``fold_ms.fold``: see ``perfbench.harness.readers.fold_ms``."""

from perfbench.harness.readers import fold_ms as read  # noqa: F401

UNIT = "ms"
