"""``launches_per_sweep`` of the lane-stacked cells, which report
``stacked_sweeps_per_s`` in place of ``sweeps_per_s``."""
from gibbsbench.metrics.launches_per_sweep import read  # noqa: F401
