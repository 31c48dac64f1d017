"""``train_tokens_per_s.fold``: see ``perfbench.harness.readers.train_tokens_per_s``."""

from perfbench.harness.readers import train_tokens_per_s as read  # noqa: F401

UNIT = "tokens/s"
