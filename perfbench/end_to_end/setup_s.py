"""``setup_s``: see ``perfbench.harness.readers.setup_s``."""

from perfbench.harness.readers import setup_s as read  # noqa: F401

UNIT = "s"
