"""The benchmark's tests: on the CPU at the smoke size, and on the card where marked ``cuda``."""
