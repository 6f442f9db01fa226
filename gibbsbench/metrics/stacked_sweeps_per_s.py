"""``sweeps_per_s`` of the lane-stacked cells (an ensemble or a tempered
ladder), under a bound of its own: their steps are paced by the
latent-distance HMC's host launches, and their rate spreads far more run
to run than a single chain's, which the card paces."""
from gibbsbench.metrics.sweeps_per_s import read  # noqa: F401
