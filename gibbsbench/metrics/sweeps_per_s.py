"""Chain-sweeps completed in the window over the window's seconds; a
stacked step of C chains or rungs counts C. The window closes with one
device synchronisation after its last step."""


def read(run):
    return run.steps * run.chains / run.window_s
