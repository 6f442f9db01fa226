"""The step's algorithmic FLOPs (work/sweep.py) times the steps of the
timed window, over the window's seconds and the card's peak, in %."""
from gibbsbench import peaks, spec


def read(run):
    flops = sum(f for f, _ in spec.work_counter("sweep")(run.shape))
    return 100.0 * flops * run.steps / (run.window_s * peaks.PEAK_FLOPS)
