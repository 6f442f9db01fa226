"""Whole steps traced under torch.profiler, reduced to what the per-layer
readers need: the device's operations (kernels, copies and sets) with
their names and intervals over a stretch traced on the device alone, and
the host operations that ran while the device idled, from a second
stretch traced with the host's operations too.

Device time is the union of the operations' intervals over every stream:
two kernels that overlap count once.
"""
from __future__ import annotations

import bisect
import time

import torch

_LOOK_BACK = 256


def union(intervals) -> list:
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(intervals, lo, hi) -> float:
    """Length of the union of `intervals` inside [lo, hi)."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


class Trace:
    """dev: [(name, start_s, end_s)] device operations of the traced
    steps, recorded with nothing else, so that the host runs as it does
    untraced; (t0, t1): the stretch; steps: the steps it holds; idle:
    [(host op, seconds)] of a second stretch traced with the host's
    operations too (which slow the host), naming what the host did while
    the device was idle."""

    def __init__(self, dev, t0, t1, steps, idle=()):
        self.dev, self.t0, self.t1, self.steps = dev, t0, t1, steps
        self.idle = list(idle)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return covered([(s, e) for _, s, e in self.dev], self.t0, self.t1)

    def kernel_s(self, patterns) -> float:
        """Summed device seconds of operations whose name holds one of
        `patterns`, inside the stretch."""
        return sum(min(e, self.t1) - max(s, self.t0)
                   for name, s, e in self.dev
                   if any(p in name for p in patterns)
                   and e > self.t0 and s < self.t1)

    def breakdown(self, top: int = 10) -> dict:
        ops, idle = {}, {}
        for name, s, e in self.dev:
            if e > self.t0 and s < self.t1:
                ops[name] = ops.get(name, 0.0) + (e - s)
        for name, sec in self.idle:
            idle[name] = idle.get(name, 0.0) + sec

        def best(d):
            return [[k[:160], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def idle_gaps(dev, host, t0, t1, samples: int = 8) -> list:
    """[(host op, seconds)]: each idle stretch of the device inside
    [t0, t1), split over `samples` points and each share named by the
    innermost host operation running there ("python" where none is)."""
    merged = union([(s, e) for _, s, e in dev])
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for lo, hi in zip(edges[::2], edges[1::2]):
        lo, hi = max(lo, t0), min(hi, t1)
        if hi <= lo:
            continue
        for k in range(samples):
            at, name = lo + (k + 0.5) * (hi - lo) / samples, "python"
            # The innermost op is the latest to start among those still
            # running; look back a bounded number of ops for it.
            i = bisect.bisect_right(starts, at) - 1
            for j in range(i, max(i - _LOOK_BACK, -1), -1):
                if host[j][2] > at:
                    name = host[j][0]
                    break
            out.append((name, (hi - lo) / samples))
    return out


def _events(prof):
    """([(name, s, e)] device operations, [(name, s, e)] host ones)."""
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            host.append((ev.name(), s, e))
        elif not ev.is_user_annotation():
            dev.append((ev.name(), s, e))     # kernels, copies and sets
    return dev, host


def _stretch(step, n, activities, sync):
    """Trace n steps between synchronisations; the profiler's clock is
    the system's, so the stretch's ends are read from time.time_ns."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        sync()
        t0 = time.time_ns() * 1e-9
        for _ in range(n):
            step()
        sync()
        t1 = time.time_ns() * 1e-9
    return _events(prof), t0, t1


def trace_steps(step, n: int, n_host: int) -> Trace:
    """n steps traced on the device alone, for the metrics, then n_host
    steps traced with the host's operations, for the names of the idle
    stretches."""
    from torch.profiler import ProfilerActivity
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    step()                                # absorbs the profiler's start
    sync()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    (dev, _), t0, t1 = _stretch(step, n, acts, sync)
    if cuda and dev and not (t0 - 0.01 <= min(s for _, s, _ in dev)
                             and max(e for _, _, e in dev) <= t1 + 0.01):
        raise RuntimeError("the device trace lies outside its stretch: "
                           "the profiler's clock is not the system's")
    (dev_h, host), h0, h1 = _stretch(
        step, n_host, [ProfilerActivity.CPU] + acts * cuda, sync)
    return Trace(dev, t0, t1, n, idle_gaps(dev_h, host, h0, h1))
