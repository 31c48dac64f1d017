"""``peak_mem_gib``: see ``perfbench.harness.readers.peak_mem_gib``."""

from perfbench.harness.readers import peak_mem_gib as read  # noqa: F401

UNIT = "GiB"
