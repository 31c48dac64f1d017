"""``mfu.train``: see ``perfbench.harness.readers.mfu``."""

from perfbench.harness.readers import mfu as read  # noqa: F401

UNIT = "%"
