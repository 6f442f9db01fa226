"""Metric readers, one file a metric, named as in BENCHMARK.json:
``read(run) -> float | None`` from a finished run (run.Run). A reader
that finds nothing to read returns None, and the metric is left out of
the result line."""
from gibbsbench import peaks, spec


def roofline(run, kernel: str, patterns) -> float | None:
    """The kernel's share of its roofline in %: the least time of its
    launches in the traced steps over their device time in the trace."""
    tr = run.trace
    launches = spec.work_counter(kernel)(run.shape)
    if tr is None or not launches:
        return None
    measured = tr.kernel_s(patterns)
    if measured <= 0:
        return None
    return 100.0 * tr.steps * peaks.least_seconds(launches) / measured
