"""Tracing and profiling helpers (PyTorch counterpart of
``pyglm_tpu/diagnostics/profiling.py``).

- :func:`force_sync`: wait for the card (``torch.cuda.synchronize``) when a
  tensor of its argument lives there.
- :class:`PhaseTimer`: wall-clocks named phases, each ending in a sync of
  the tensor the phase puts in its box.
- :func:`trace`: a ``torch.profiler`` Chrome trace of a block.
- :func:`sweep_breakdown`: the seconds of each stage of one Gibbs sweep at
  a model's registered data.

``profile_sweep.py`` (this folder) is the script that profiles whole
sweeps at the main paths' shapes; these helpers are the library's.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


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
