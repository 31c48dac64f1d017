"""``round_host_ms.train``: see ``perfbench.harness.readers.round_host_ms``."""

from perfbench.harness.readers import round_host_ms as read  # noqa: F401

UNIT = "ms"
