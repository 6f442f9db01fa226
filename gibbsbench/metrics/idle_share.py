"""The share of the traced steps' wall time in which no operation ran on
the device: 1 - (the union of kernel, copy and set intervals over every
stream) / the stretch's wall time, in %."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
