"""Seconds from the start of the process to the first timed step: the
imports, the kernels' build where it is not cached, the inputs made from
the seed, the model's data and state, and the warm-up steps."""


def read(run):
    return run.setup_s
