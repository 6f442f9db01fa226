"""Tracing and profiling helpers (PyTorch counterpart of
``pyglm_tpu/diagnostics/profiling.py``).

- :func:`force_sync`: wait for the card (``torch.cuda.synchronize``) when a
  tensor of its argument lives there.
- :class:`PhaseTimer`: wall-clocks named phases, each ending in a sync of
  the tensor the phase puts in its box.
- :func:`trace`: a ``torch.profiler`` Chrome trace of a block.
- :func:`sweep_breakdown`: the seconds of each stage of one Gibbs sweep at
  a model's registered data.
- :func:`recording`, :func:`span`, :func:`wait`, :func:`count`: the span
  recorder. The sweeps mark their stages with ``span`` and each call that
  blocks the host on the card with ``wait``; nothing is recorded unless a
  caller turns recording on.

``profile_sweep.py`` (this folder) is the script that profiles whole
sweeps at the main paths' shapes; these helpers are the library's.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch

# The Recording that recording() has turned on, or None.
_ACTIVE = None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def force_sync(x):
    """Return `x` after the work that makes it is done: synchronizes each
    CUDA device that holds a tensor of `x` (nested in tuples, lists and
    dicts); CPU tensors are ready when returned."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


class PhaseTimer:
    """Accumulated wall seconds per named phase."""

    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block; put its result in the yielded box as
        ``box["out"]`` so that the phase ends when that result is ready."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "out" in box:
                force_sync(box["out"])
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'phase':24s} {'ms':>9s} {'%':>6s}"]
        for k, v in self.times.items():
            lines.append(f"{k:24s} {v * 1e3:9.1f} "
                         f"{100 * v / max(total, 1e-30):6.1f}")
        lines.append(f"{'TOTAL':24s} {total * 1e3:9.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the host, and the card
    where there is one) and write a Chrome trace to
    ``<logdir>/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler: ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def sweep_breakdown(model, n_reps: int = 3) -> OrderedDict:
    """Mean seconds per stage of one Gibbs sweep at the model's registered
    data, each stage ending in a sync: 'psi_matmul' (psi = Xf w),
    'pg_draws' (the family's omega, kappa: K1 or K4 on the card),
    'group_gram' (every group's Gram at the model's precision: K6),
    'spike_slab_scan' (the whole spike-and-slab update, spike-and-slab
    models only) and 'network_resample'. The stages draw from generators
    of their own; the model's state and generators are untouched."""
    from pyglm_tpu_torch.models.ensemble import chain_generators
    from pyglm_tpu_torch.models.sweep import concat_datas
    from pyglm_tpu_torch.models.weights import (
        group_gram_blocks, pack_weights, resample_spike_slab_tspace)
    from pyglm_tpu_torch.utils.utils import fp32_matmul

    if not model.datas:
        raise RuntimeError("call add_data() first")
    Y, Xf, Xt = concat_datas(model.datas)
    state, B, G = model.state, model.B, model.group
    w_full = pack_weights(state.A, state.W, state.b)
    hyp = model.network.edge_hypers(state.net, model.device)
    gens = chain_generators(0, model.device)

    def psi_f():
        with fp32_matmul():
            return Xf @ w_full

    def pg_f(psi):
        return model.observation.omega_kappa(gens.host, Y, psi, state.aux)

    def gram_f(omega):
        return group_gram_blocks(Xt, omega, B, G,
                                 precision=model.precision)

    def ss_f(omega, kappa, psi):
        with fp32_matmul():
            return resample_spike_slab_tspace(
                gens.device, Xt, omega, kappa, psi, w_full, hyp, B,
                group=G, precision=model.precision, host_generator=gens.host)

    def net_f():
        return model.network.resample(gens, state.net, state.A, state.W)

    # Warm-up: the kernels' first launches (and their build) out of the
    # timings.
    psi = force_sync(psi_f())
    omega, kappa = force_sync(pg_f(psi))
    force_sync(gram_f(omega))
    if model.spike_and_slab:
        force_sync(ss_f(omega, kappa, psi))
    force_sync(net_f())

    pt = PhaseTimer()
    for _ in range(n_reps):
        with pt.phase("psi_matmul") as box:
            box["out"] = psi_f()
        with pt.phase("pg_draws") as box:
            box["out"] = pg_f(psi)
        with pt.phase("group_gram") as box:
            box["out"] = gram_f(omega)
        if model.spike_and_slab:
            with pt.phase("spike_slab_scan") as box:
                box["out"] = ss_f(omega, kappa, psi)
        with pt.phase("network_resample") as box:
            box["out"] = net_f()
    return OrderedDict((k, v / n_reps) for k, v in pt.times.items())


class Recording:
    """What one :func:`recording` holds, stamped by ``time.time_ns``, the
    clock of torch.profiler's device events, so that a span and a kernel
    can be laid side by side.

    - ``spans``: ``[name, parent, step, start_ns, end_ns]`` a span, in the
      order they opened: `parent` the index of the span around it, `step`
      the index in ``steps`` of the step around it (-1: none).
    - ``steps``: a dict a step span: ``name``, ``span`` (its index),
      ``waits`` (the ``wait`` spans inside it) and ``launches`` (the
      change of each ``ops._build.LAUNCHES`` count that moved while it
      ran).
    - ``counts``: set-up counters; ``kernel_builds`` is 1 where the
      kernels' library was built with nvcc and 0 where the built one was
      loaded.

    A span's self time is its own time less its children's.
    """

    def __init__(self):
        self.spans, self.steps, self.counts = [], [], {}
        self._open, self._step = [], -1

    def path(self, i: int) -> str:
        """Span i's name after those of the spans around it, '/'-joined,
        from below its step's span (which names itself)."""
        names = []
        while i >= 0:
            name, parent, step = self.spans[i][:3]
            if names and step >= 0 and self.steps[step]["span"] == i:
                break
            names.append(name)
            i = parent
        return "/".join(reversed(names))

    def self_ns(self) -> list:
        """Each span's self time in ns."""
        out = [e - s for _, _, _, s, e in self.spans]
        for _, parent, _, s, e in self.spans:
            if parent >= 0:
                out[parent] -= e - s
        return out

    def table(self) -> list:
        """[(path, calls, total ns, self ns)] summed over the spans of each
        path, the largest self time first."""
        rows = {}
        for i, own in enumerate(self.self_ns()):
            _, _, _, s, e = self.spans[i]
            r = rows.setdefault(self.path(i), [0, 0, 0])
            r[0] += 1
            r[1] += e - s
            r[2] += own
        return sorted(((p, *r) for p, r in rows.items()),
                      key=lambda row: -row[3])


class _NoSpan:
    """The span of a sweep that nobody records: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "kind", "i", "launch0")

    def __init__(self, rec: Recording, name: str, kind: str):
        self.rec, self.name, self.kind = rec, name, kind

    def __enter__(self):
        rec = self.rec
        if self.kind == "step":
            if rec._step < 0:
                from pyglm_tpu_torch.ops import _build
                self.launch0 = dict(_build.LAUNCHES)
                rec._step = len(rec.steps)
                rec.steps.append({"name": self.name, "span": len(rec.spans),
                                  "waits": 0, "launches": {}})
            else:                   # a step inside a step is a stage of it
                self.kind = "span"
        elif self.kind == "wait" and rec._step >= 0:
            rec.steps[rec._step]["waits"] += 1
        self.i = len(rec.spans)
        rec.spans.append([self.name, rec._open[-1] if rec._open else -1,
                          rec._step, time.time_ns(), 0])
        rec._open.append(self.i)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.i][4] = time.time_ns()
        rec._open.pop()
        if self.kind == "step":
            from pyglm_tpu_torch.ops import _build
            rec.steps[rec._step]["launches"] = {
                k: v - self.launch0.get(k, 0)
                for k, v in _build.LAUNCHES.items()
                if v != self.launch0.get(k, 0)}
            rec._step = -1
        return False


def span(name: str, step: bool = False):
    """A context manager around one stage of the program. Without a
    recording on it returns the shared ``NO_SPAN`` and reads no clock.
    `step`: the span is one step of a loop (a sweep) and numbers the spans
    inside it; a step inside a step is a stage of the outer one."""
    rec = _ACTIVE
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, "step" if step else "span")


def wait(name: str):
    """A span named ``wait.<name>`` around one call that blocks the host
    until the card has done its queued work (a read of a device value, a
    copy from pageable host memory to the card, an index whose size the
    card computes); it adds one to its step's ``waits``."""
    rec = _ACTIVE
    if rec is None:
        return NO_SPAN
    return _Span(rec, "wait." + name, "wait")


def count(name: str, n: int = 1) -> None:
    """Add `n` to the recording's counter `name`."""
    if _ACTIVE is not None:
        _ACTIVE.counts[name] = _ACTIVE.counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record the spans of the block (nothing is written anywhere): yields
    the :class:`Recording`. One recording at a time, on the thread that
    runs the sweeps."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a recording is already on")
    rec = _ACTIVE = Recording()
    try:
        yield rec
    finally:
        _ACTIVE = None
