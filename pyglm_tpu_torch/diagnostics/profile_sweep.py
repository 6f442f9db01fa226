"""Where the time of one sweep goes on the card.

    python -m pyglm_tpu_torch.diagnostics.profile_sweep
        [flagship|nb|ensemble] [--precision default|sr|high|highest]

``flagship``: SparseBernoulliGLM(200, B=4, L=10) on synthetic spikes at rate
0.15, T=100k, 3 warm-up sweeps, 20 timed sweeps, then 5 traced sweeps (it
uses only the model API, so it also times an older checkout of the package
put first on PYTHONPATH). ``nb``: the NB flagship of benchmarks/common.py,
SparseNegativeBinomialGLM(200, B=4, L=10, max_y=16) fitted to T=100k counts
of a truth model (seed 42, sigma_w=0.003, mu_bias=-2.0, counts capped at
15), timed as ``flagship``. ``ensemble``: the
acceptance suite's config 5 (latent-distance truth N=500, T=20k,
mu_bias=-3), the lane-stacked sweep of 8 chains, 2 warm-up sweeps, then 2
traced sweeps. Prints, per sweep: the wall time untraced (host clock, ending
in a synchronize) and traced, the device busy time and idle share, the
kernel time by name (torch.profiler), and for the ensemble the time of the
spike-and-slab update, of K6 alone and of the network resample (HMC and
NIW) alone, each timed apart on the same state. Every model, sweep and
update runs at ``--precision`` ("high" by default, as the models). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch


def _wall(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _trace(fn, reps):
    """(traced ms per call, {kernel name: device ms per call}). One untimed
    call inside the trace absorbs the profiler's start-up; the kernel times
    are averaged over every traced call."""
    from torch.profiler import ProfilerActivity, profile
    wall = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                wall += time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.device_type.name == "CUDA":
            kernels[ev.key] = (kernels.get(ev.key, 0.0)
                               + dev_us / 1e3 / (1 + reps))
    return wall * 1e3 / reps, kernels


def _report(name, untraced, traced, kernels, top=14):
    busy = sum(kernels.values())
    print(f"{name}: {untraced:.2f} ms per sweep untraced, {traced:.2f} "
          f"traced, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / traced:.3f}")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {v:9.3f} ms  {100 * v / busy:5.1f}%  {k[:90]}")


def flagship(precision):
    from pyglm_tpu_torch import SparseBernoulliGLM
    N, T = 200, 100_000
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.15).float()
    m = SparseBernoulliGLM(N, B=4, L=10, seed=0, precision=precision,
                           device="cuda")
    m.add_data(Y)
    for _ in range(3):
        m.resample_model()
    untraced = _wall(m.resample_model, 20)
    traced, kernels = _trace(m.resample_model, 5)
    _report(f"flagship sweep ({precision})", untraced, traced, kernels)


def nb(precision):
    import numpy as np
    from pyglm_tpu_torch import SparseNegativeBinomialGLM
    N, T = 200, 100_000
    kw = dict(B=4, L=10, obs_kwargs=dict(max_y=16), device="cuda")
    truth = SparseNegativeBinomialGLM(
        N, seed=42, net_kwargs=dict(rho_init=0.05, learn_rho=False,
                                    mu_bias=-2.0, sigma_bias=0.25,
                                    learn_weight_prior=False, sigma_w=0.003),
        **kw)
    Y = np.minimum(truth.generate(T, keep=False), 15.0)
    m = SparseNegativeBinomialGLM(N, seed=0, precision=precision, **kw)
    m.add_data(Y)
    for _ in range(3):
        m.resample_model()
    untraced = _wall(m.resample_model, 20)
    traced, kernels = _trace(m.resample_model, 5)
    _report(f"NB flagship sweep ({precision})", untraced, traced, kernels)


def ensemble(precision):
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models.ensemble import (
        chain_generators, lane_inputs, make_stacked_sweep, stack_states,
        unstack_states)
    from pyglm_tpu_torch.models.sweep import init_state_from_prior
    from pyglm_tpu_torch.models.weights import (
        group_gram_blocks, resample_spike_slab_tspace)
    N, T, C, B = 500, 20_000, 8, 4
    kw = dict(B=B, L=10, observation="bernoulli",
              network="latent_distance", spike_and_slab=True)
    truth = NonlinearAutoregressiveModel(
        N, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0), **kw)
    m = NonlinearAutoregressiveModel(N, seed=0, net_kwargs=dict(dim=2),
                                     precision=precision, **kw)
    m.add_data(truth.generate(T, keep=False))
    st = stack_states([init_state_from_prior(
        chain_generators(sd, "cuda"), m.observation, m.network, N, B, True,
        "cuda") for sd in range(1, C + 1)])
    gens = chain_generators(99, "cuda")
    sweep = make_stacked_sweep(m.observation, m.network, N, B, C, True,
                               group=m.group, precision=precision)
    datas = tuple(m.datas)
    for _ in range(2):
        st, _ = sweep(gens, st, datas)
    box = [st]

    def one():
        box[0], _ = sweep(gens, box[0], datas)
    untraced = _wall(one, 3)
    traced, kernels = _trace(one, 2)
    _report(f"ensemble stacked sweep ({C} chains x {N}, {precision})",
            untraced, traced, kernels)
    d = m.datas[0]
    chains = unstack_states(box[0], C)
    w, hyp = lane_inputs(m.network, chains)
    psi = d.Xf @ w
    omega, kappa = m.observation.omega_kappa(gens.host, d.Y.repeat(1, C),
                                             psi, None)
    ss_ms = _wall(lambda: resample_spike_slab_tspace(
        gens.device, d.Xt, omega, kappa, psi, w, hyp, B, group=m.group,
        precision=precision, host_generator=gens.host), 3)
    k6_ms = _wall(lambda: group_gram_blocks(d.Xt, omega, B, m.group,
                                            precision=precision), 3)
    st1 = box[0]
    net_ms = _wall(lambda: m.network.resample(gens, st1.net, st1.A, st1.W),
                   3)
    print(f"  apart, on the same state: spike-and-slab update {ss_ms:.2f} ms"
          f" (K6 alone {k6_ms:.2f} ms), network resample (HMC + NIW) "
          f"{net_ms:.2f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="*",
                    choices=["flagship", "nb", "ensemble"])
    ap.add_argument("--precision", default="high",
                    choices=["default", "sr", "high", "highest"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for c in args.config or ["flagship", "ensemble"]:
        {"flagship": flagship, "nb": nb,
         "ensemble": ensemble}[c](args.precision)


if __name__ == "__main__":
    main()
