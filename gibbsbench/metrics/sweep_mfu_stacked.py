"""``sweep_mfu`` of the lane-stacked cells, which report
``stacked_sweeps_per_s`` in place of ``sweeps_per_s``."""
from gibbsbench.metrics.sweep_mfu import read  # noqa: F401
