"""``idle_share`` of the lane-stacked cells, which report
``stacked_sweeps_per_s`` in place of ``sweeps_per_s``."""
from gibbsbench.metrics.idle_share import read  # noqa: F401
