"""Partition rules of the port (``partition.py``): parameter, cache and
batch specs as DTensor placements, and the layer-boundary ``constrain``."""
