"""Device operations (kernels, copies, sets) in the trace per traced
step: a stacked step of C chains counts once."""


def read(run):
    tr = run.trace
    if tr is None or not tr.dev:
        return None
    n = sum(1 for _, s, e in tr.dev if e > tr.t0 and s < tr.t1)
    return n / tr.steps
