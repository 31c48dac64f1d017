"""``fedavg_roofline.fold``: see ``perfbench.harness.readers.fedavg_roofline``."""

from perfbench.harness.readers import fedavg_roofline as read  # noqa: F401

UNIT = "%"
