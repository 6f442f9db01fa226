"""The 95th percentile, over every step of the window, of a step's time:
from its start to the next step's start (the last: to the window's
close), on the host clock, with no synchronisation but the program's
own."""
import numpy as np


def read(run):
    t = np.asarray(run.step_starts + [run.window_end])
    return float(np.percentile(np.diff(t), 95) * 1e3)
