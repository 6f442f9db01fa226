"""Where the time of one sweep goes on the card.

    python -m pyglm_tpu_torch.diagnostics.profile_sweep
        [flagship|nb|ensemble|dense|sbm|gaussian|tempered]
        [--precision default|sr|high|highest]

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
NIW) alone, each timed apart on the same state. ``dense``: acceptance
config 1, BernoulliGLM(27, B=4, L=10) on its truth's T=60k bins; ``sbm``:
acceptance config 4 (SBM prior, K=5, N=100) on its truth's T=40k bins,
with the network resample and its label scan timed apart (host clock);
``gaussian``: SparseGaussianGLM(200, B=4, L=10) on T=100k bins of unit
Gaussian noise (the staged loop on the cached group Gram); each timed as
``flagship``. ``tempered``: config 5's model tempered (models/
tempering.py), 8 rungs on the ladder of a 20 + 20-sweep pilot
(fit_tempered's), 2 warm-up tempered sweeps, 3 timed, 2 traced. Every
model, sweep and update runs at ``--precision`` ("high" by default, as
the models). Needs a CUDA card.
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


def _timed(m, label):
    for _ in range(3):
        m.resample_model()
    untraced = _wall(m.resample_model, 20)
    traced, kernels = _trace(m.resample_model, 5)
    _report(label, untraced, traced, kernels)


def flagship(precision):
    from pyglm_tpu_torch import SparseBernoulliGLM
    N, T = 200, 100_000
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.15).float()
    m = SparseBernoulliGLM(N, B=4, L=10, seed=0, precision=precision,
                           device="cuda")
    m.add_data(Y)
    _timed(m, f"flagship sweep ({precision})")


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
    _timed(m, f"NB flagship sweep ({precision})")


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


def tempered(precision):
    import warnings
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models import tempering
    N, T, C = 500, 20_000, 8
    kw = dict(B=4, L=10, observation="bernoulli",
              network="latent_distance", spike_and_slab=True)
    truth = NonlinearAutoregressiveModel(
        N, seed=5, net_kwargs=dict(dim=2, mu_bias=-3.0), **kw)
    m = NonlinearAutoregressiveModel(N, seed=0, net_kwargs=dict(dim=2),
                                     precision=precision, **kw)
    m.add_data(truth.generate(T, keep=False))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # the NARROW ladder
        betas = m.fit_tempered(n_samples=1, n_rungs=C,
                               pilot_sweeps=20)["betas"]
    sweep = tempering.make_tempered_sweep(
        m.observation, m.network, N, 4, betas, group=m.group,
        precision=precision)
    box = [tempering.init_tempered_states(m, betas)]
    gens = tempering.tempered_generators(range(1, C + 1), "cuda")
    datas = tuple(m.datas)

    def one():
        box[0], _ = sweep(gens, box[0], datas)
    for _ in range(2):
        one()
    untraced = _wall(one, 3)
    traced, kernels = _trace(one, 2)
    _report(f"tempered sweep ({C} rungs x {N}, betas "
            f"{betas[0]:.4f}..1, {precision})", untraced, traced, kernels)


def _fitted(name, precision):
    """Acceptance config `name`'s fitted model on its truth's bins."""
    from pyglm_tpu_torch import acceptance as acc
    T = acc.lengths(name, False)[0]
    Y = acc.make_truth(name, "cuda").generate(T, keep=False)
    m = acc.make_model(name, precision, "cuda")
    m.add_data(Y)
    return m


def dense(precision):
    _timed(_fitted("1_bernoulli_dense", precision),
           f"config 1 dense sweep, N=27, T=60k ({precision})")


def sbm(precision):
    import numpy as np
    m = _fitted("4_sbm", precision)
    _timed(m, f"config 4 SBM sweep, N=100, K=5, T=40k ({precision})")
    st, net = m.state, m.network
    net_ms = _wall(lambda: net.resample(m.generators, st.net, st.A, st.W), 10)
    tabs = [x.double().cpu().numpy() for x in
            net._scan_tables(net._edge_tables(st.net, st.A, st.W))]
    c, pi = st.net.c.numpy(), st.net.pi.double().numpy()
    u = np.random.default_rng(0).random(net.N)
    t0 = time.perf_counter()
    for _ in range(10):
        net._label_scan(*tabs, c, pi, u)
    scan_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"  apart: the SBM resample {net_ms:.2f} ms (host clock), its "
          f"label scan alone {scan_ms:.2f} ms (host)")


def gaussian(precision):
    from pyglm_tpu_torch import SparseGaussianGLM
    N, T = 200, 100_000
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = SparseGaussianGLM(N, B=4, L=10, seed=0, precision=precision,
                          device="cuda")
    m.add_data(torch.randn((T, N), generator=gen, device="cuda"))
    _timed(m, f"sparse Gaussian sweep, N=200, T=100k ({precision})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="*",
                    choices=["flagship", "nb", "ensemble", "dense", "sbm",
                             "gaussian", "tempered"])
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
        {"flagship": flagship, "nb": nb, "ensemble": ensemble,
         "dense": dense, "sbm": sbm, "gaussian": gaussian,
         "tempered": tempered}[c](args.precision)


if __name__ == "__main__":
    main()
