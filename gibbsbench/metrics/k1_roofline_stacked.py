"""``k1_roofline`` of the lane-stacked cells, which report
``stacked_sweeps_per_s`` in place of ``sweeps_per_s``."""
from gibbsbench.metrics.k1_roofline import read  # noqa: F401
