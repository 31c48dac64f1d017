"""``device_idle_pct.fold``: see ``perfbench.harness.readers.device_idle_pct``."""

from perfbench.harness.readers import device_idle_pct as read  # noqa: F401

UNIT = "%"
