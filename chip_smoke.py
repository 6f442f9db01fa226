#!/usr/bin/env python3
"""Smoke test of pyglm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc and PyTorch built for CUDA; it imports nothing of JAX.

  0. Pre-flight: CUDA must be present (else exit 2). Prints the card's name
     and power limit and builds the kernels from ``pyglm_tpu_torch/csrc``.
  1. Kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the flagships' shapes (N=200, T=100k, B=4, G=8), with the
     median time of each: K1-K3, then the NB kernels K4 (gamma-series PG)
     and K5 (CRT counts).
  2. Slices, each run with the launch counts set to 0 just before and read
     just after: a ground-truth SparseBernoulliGLM(200, B=4, L=10)
     generates T=100k bins and a fresh model fits them (2 warm-up + 5 timed
     sweeps); the same for SparseNegativeBinomialGLM (max_y=16, counts
     capped at 15), followed by one NB dispersion update without the count
     table, which runs K5. Then small models on the card are held against
     the same models on the CPU (Bernoulli and NB): same state, same PG
     draws and noise, same result.

Any failed check exits 1 and prints no result line. On success the last
three lines are the card's name and power limit (as nvidia-smi prints
them), the per-kernel JSON record, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

N, T, B, L, G = 200, 100_000, 4, 10, 8
N_WARMUP, N_TIMED = 2, 5
# The flagship truth model of bench.py.
TRUTH_NET = dict(rho_init=0.05, learn_rho=False, mu_bias=-2.5,
                 sigma_bias=0.25, learn_weight_prior=False, sigma_w=1.0)
# The NB flagship truth model of benchmarks/common.py.
NB_TRUTH_NET = dict(rho_init=0.05, learn_rho=False, mu_bias=-2.0,
                    sigma_bias=0.25, learn_weight_prior=False, sigma_w=0.003)
NB_OBS = dict(max_y=16)
NB_GRID = [(0.3, 1.0), (1.0, 2.0), (2.5, 0.0), (4.5, 1.0), (13.0, 1.0),
           (40.0, 6.0)]
CRT_GRID = [(1, 0.5), (4, 2.0), (12, 5.0), (15, 0.7)]
KS_P_MIN = 1e-3          # two-sample KS gate, per c
REL_TOL = 1e-4           # K2, small slice: max |card - plain| / max |plain|
W_ATOL = 1e-4            # K3: weights

KERNELS = {
    "pg_devroye": ("pyglm_tpu_torch/csrc/pg_devroye.cu",
                   "pyglm_tpu/ops/pg_pallas.py:85"),
    "ss_group_pass": ("pyglm_tpu_torch/csrc/ss_group_pass.cu",
                      "pyglm_tpu/ops/ss_pallas.py:283"),
    "ss_edge_scan": ("pyglm_tpu_torch/csrc/ss_edge_scan.cu",
                     "pyglm_tpu/ops/ss_pallas.py:153"),
    "pg_gamma_series": ("pyglm_tpu_torch/csrc/pg_gamma.cu",
                        "pyglm_tpu/ops/pg_pallas.py:452"),
    "crt_sample": ("pyglm_tpu_torch/csrc/crt.cu",
                   "pyglm_tpu/ops/pg_pallas.py:650"),
}


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failed.append(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps):
    import torch
    fn()                                   # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_kernels(check, record):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch.ops.basis import design_matrix, cosine_basis
    from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
    from pyglm_tpu_torch.ops.polyagamma import (
        pg_devroye_plain, pg_mean, pg_var)
    from pyglm_tpu_torch.ops.ss_cuda import (
        ss_edge_scan_cuda, ss_edge_scan_plain, ss_group_pass_cuda,
        ss_group_pass_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1234)

    # --- K1: PG(1, psi) over a (T, N) psi in the flagship's range --------
    print("K1 pg_devroye: PG(1, psi) at (100000, 200)", flush=True)
    psi = -2.5 + 2.0 * torch.randn((T, N), generator=gen, device=dev)
    om = pg_devroye_cuda(psi, 1, 0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(om).all() and (om > 0).all()),
          "K1 draws finite and positive")
    m, v = pg_mean(1.0, psi).double(), pg_var(1.0, psi).double()
    z = float((om.double().sum() - m.sum()) / v.sum().sqrt())
    var_ratio = float(((om.double() - m) ** 2).sum() / v.sum())
    check(abs(z) < 5.0, f"K1 sum vs pg_mean: z = {z:.3f} (|z| < 5)")
    check(abs(var_ratio - 1.0) < 0.01,
          f"K1 spread vs pg_var: ratio = {var_ratio:.5f} (within 1%)")
    worst = 0.0
    for c in (0.0, 0.5, 2.0, 8.0, 30.0):
        cv = torch.full((200_000,), c, device=dev)
        k = pg_devroye_cuda(cv, 7 + int(c * 10), 0)
        p = pg_devroye_plain(cv, gen)
        ks = ks_2samp(k.cpu().numpy(), p.cpu().numpy())
        dmean = abs(float(k.double().mean() - p.double().mean()))
        worst = max(worst, dmean)
        check(ks.pvalue > KS_P_MIN,
              f"K1 vs plain at c={c}: KS D={ks.statistic:.5f} "
              f"p={ks.pvalue:.4f}, |mean diff|={dmean:.2e}, "
              f"pg_mean={float(pg_mean(1.0, c)):.6f}")
    ms = median_ms(lambda: pg_devroye_cuda(psi, 3, 0), 10)
    plain_ms = median_ms(lambda: pg_devroye_plain(psi, gen), 3)
    record["pg_devroye"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
    print(f"  K1 {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(max_abs_err = largest |mean diff| over the five c)")

    # --- K2: one group pass at GB=32, T=100k, N=200 -----------------------
    print("K2 ss_group_pass: group g=3 of 25, GB=32", flush=True)
    GB = G * B
    Y = (torch.rand((T, N), generator=gen, device=dev) < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(B, L)).T.contiguous()
    xp, xg = Xt[2 * GB:3 * GB], Xt[3 * GB:4 * GB]
    omega = 0.05 + 0.2 * torch.rand((T, N), generator=gen, device=dev)
    u0 = 0.5 * torch.randn((T, N), generator=gen, device=dev)
    dw = 0.1 * torch.randn((GB, N), generator=gen, device=dev)
    u_k, u_p = u0.clone(), u0.clone()
    out_k = ss_group_pass_cuda(xp, xg, omega, u_k, dw, True)
    out_p = ss_group_pass_plain(xp, xg, omega, u_p, dw, True)
    torch.cuda.synchronize()
    errs = {"u": rel_err(u_k, u_p)}
    for name, a, b in zip(("M0", "Jgg", "sum_omega"), out_k, out_p):
        errs[name] = rel_err(a, b)
    for name, e in errs.items():
        check(e <= REL_TOL, f"K2 {name}: max|diff|/max|plain| = {e:.2e}")
    u_e_k, u_e_p = u0.clone(), u0.clone()
    ss_group_pass_cuda(xg, None, omega, u_e_k, dw)
    ss_group_pass_plain(xg, None, omega, u_e_p, dw)
    e = rel_err(u_e_k, u_e_p)
    check(e <= REL_TOL, f"K2 epilogue (scatter only) u: {e:.2e}")
    max_abs = max(float((a - b).abs().max())
                  for a, b in [(u_k, u_p), *zip(out_k, out_p)])
    ms = median_ms(lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw), 10)
    plain_ms = median_ms(lambda: ss_group_pass_plain(xp, xg, omega, u_p, dw),
                         5)
    record["ss_group_pass"].update(max_abs_err=max_abs, ms=ms,
                                   plain_ms=plain_ms)
    print(f"  K2 {ms:.3f} ms, plain {plain_ms:.3f} ms per group")

    # --- K3: that group's edge scan, same injected noise -----------------
    print("K3 ss_edge_scan: G=8 edges x 200 lanes, B=4", flush=True)
    m0, jgg = out_p[0], out_p[1]
    mu = torch.zeros((G, N, B), device=dev)
    lam = torch.eye(B, device=dev).expand(G, N, B, B).contiguous()
    lrho = torch.full((G, N), math.log(0.25 / 0.75), device=dev)
    w0 = (torch.randn((GB, N), generator=gen, device=dev)
          * (torch.rand((GB, N), generator=gen, device=dev) < 0.25))
    u_a = torch.rand((G, N), generator=gen, device=dev)
    eps = torch.randn((G, N, B), generator=gen, device=dev)
    w_k, w_p = w0.clone(), w0.clone()
    dW_k, a_k = ss_edge_scan_cuda(jgg, m0, w_k, mu, lam, lrho, u_a, eps)
    dW_p, a_p = ss_edge_scan_plain(jgg, m0, w_p, mu, lam, lrho, u_a, eps)
    torch.cuda.synchronize()
    n_diff = int((a_k != a_p).sum())
    check(n_diff == 0, f"K3 A identical ({n_diff} of {a_k.numel()} differ; "
          f"{int(a_k.sum())} active)")
    werr = float((w_k - w_p).abs().max())
    derr = float((dW_k - dW_p).abs().max())
    check(werr <= W_ATOL and derr <= W_ATOL,
          f"K3 W max|diff| = {werr:.2e}, dW max|diff| = {derr:.2e}")
    ms = median_ms(lambda: ss_edge_scan_cuda(jgg, m0, w0.clone(), mu, lam,
                                             lrho, u_a, eps), 20)
    plain_ms = median_ms(lambda: ss_edge_scan_plain(
        jgg, m0, w0.clone(), mu, lam, lrho, u_a, eps), 5)
    record["ss_edge_scan"].update(max_abs_err=max(werr, derr), ms=ms,
                                  plain_ms=plain_ms)
    print(f"  K3 {ms:.3f} ms, plain {plain_ms:.3f} ms per group")


def phase_kernels_nb(check, record):
    """K4 and K5 against their plain versions at the NB flagship's shapes."""
    import numpy as np
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch.ops.crt_cuda import crt_sample_cuda
    from pyglm_tpu_torch.ops.linalg import crt_sample_plain, sample_gamma
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
    from pyglm_tpu_torch.ops.polyagamma import (
        pg_gamma_series_plain, pg_mean, pg_var)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4321)

    # --- K4: PG(y + r, psi) over NB-like counts at (T, N) -----------------
    print("K4 pg_gamma_series: PG(y + 4, psi) at (100000, 200)", flush=True)
    psi = -2.0 + 0.5 * torch.randn((T, N), generator=gen, device=dev)
    lam = sample_gamma(torch.full((T, N), 4.0, device=dev), gen) * psi.exp()
    y = torch.clamp(torch.poisson(lam, generator=gen), max=15.0)
    b = y + 4.0
    om = pg_gamma_series_cuda(b, psi, 1, 0, normal_cutoff=170.0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(om).all() and (om > 0).all()),
          f"K4 draws finite and positive (mean count {float(y.mean()):.3f},"
          f" max {float(y.max()):.0f})")
    m, v = pg_mean(b, psi).double(), pg_var(b, psi).double()
    z = float((om.double().sum() - m.sum()) / v.sum().sqrt())
    var_ratio = float(((om.double() - m) ** 2).sum() / v.sum())
    check(abs(z) < 5.0, f"K4 sum vs pg_mean: z = {z:.3f} (|z| < 5)")
    check(abs(var_ratio - 1.0) < 0.01,
          f"K4 spread vs pg_var: ratio = {var_ratio:.5f} (within 1%)")
    worst = 0.0
    for i, (bb, cc) in enumerate(NB_GRID):
        bv = torch.full((200_000,), bb, device=dev)
        cv = torch.full((200_000,), cc, device=dev)
        k = pg_gamma_series_cuda(bv, cv, 100 + i, 0)
        p = pg_gamma_series_plain(bv, cv, gen)
        ks = ks_2samp(k.cpu().numpy(), p.cpu().numpy())
        dmean = abs(float(k.double().mean() - p.double().mean()))
        worst = max(worst, dmean)
        check(ks.pvalue > KS_P_MIN,
              f"K4 vs plain at (b, c)=({bb}, {cc}): KS D={ks.statistic:.5f} "
              f"p={ks.pvalue:.4f}, |mean diff|={dmean:.2e}, "
              f"pg_mean={float(pg_mean(bb, cc)):.6f}")
    ms = median_ms(lambda: pg_gamma_series_cuda(b, psi, 3, 0,
                                                normal_cutoff=170.0), 10)
    plain_ms = median_ms(lambda: pg_gamma_series_plain(b, psi, gen, 170.0), 3)
    record["pg_gamma_series"].update(max_abs_err=worst, ms=ms,
                                     plain_ms=plain_ms)
    print(f"  K4 {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(max_abs_err = largest |mean diff| over the grid)")

    # --- K5: CRT counts, exact law, and at (T, N) -------------------------
    print("K5 crt_sample: exact law, then (100000, 200)", flush=True)
    worst = 0.0
    for i, (yv, rv) in enumerate(CRT_GRID):
        yy = torch.full((200_000, 1), yv, dtype=torch.int32, device=dev)
        rr = torch.tensor([rv], device=dev)
        k = crt_sample_cuda(yy, rr, 16, 200 + i, 0).double()
        p = crt_sample_plain(yy, rr, 16, gen).double()
        ps = np.array([rv / (rv + j) for j in range(yv)])
        mean, var = ps.sum(), (ps * (1 - ps)).sum()
        se = math.sqrt(var / 200_000) + 1e-6
        dmean = abs(float(k.mean() - p.mean()))
        worst = max(worst, dmean)
        ks = ks_2samp(k.cpu().numpy()[:, 0], p.cpu().numpy()[:, 0])
        check(abs(float(k.mean()) - mean) < 6 * se + 1e-3
              and (var < 1e-6 or abs(float(k.var()) / var - 1) < 0.05),
              f"K5 law at (y, r)=({yv}, {rv}): mean {float(k.mean()):.4f} "
              f"vs {mean:.4f}, var {float(k.var()):.4f} vs {var:.4f}")
        check(ks.pvalue > KS_P_MIN,
              f"K5 vs plain at (y, r)=({yv}, {rv}): KS D={ks.statistic:.5f} "
              f"p={ks.pvalue:.4f}, |mean diff|={dmean:.2e}")
    r = 0.5 + 4.0 * torch.rand((N,), generator=gen, device=dev)
    yi = y.to(torch.int32)
    ms = median_ms(lambda: crt_sample_cuda(yi, r, 16, 5, 0), 10)
    plain_ms = median_ms(lambda: crt_sample_plain(yi, r, 16, gen), 3)
    record["crt_sample"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms)
    print(f"  K5 {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(max_abs_err = largest |mean diff| over the grid)")


def phase_slice(check, record):
    """The flagship through the user entry points: generate, add_data,
    resample_model, fit, log_likelihood; the launch counts of that run."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.utils.metrics import link_auc

    print(f"slice: truth model N={N}, generate T={T}", flush=True)
    truth = SparseBernoulliGLM(N, B=B, L=L, seed=42, net_kwargs=TRUTH_NET,
                               device="cuda")
    t0 = time.perf_counter()
    Y = truth.generate(T, keep=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"  generate: {gen_s:.2f} s, "
          f"rate {Y.mean():.4f} spikes/bin, {int(truth.A.sum())} true edges")

    model = SparseBernoulliGLM(N, B=B, L=L, seed=0, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    model.add_data(Y)
    torch.cuda.synchronize()
    print(f"  add_data: {time.perf_counter() - t0:.3f} s")
    lls = []
    t0 = time.perf_counter()
    for _ in range(N_WARMUP):
        lls.append(model.resample_model()["log_likelihood"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = model.fit(n_samples=N_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    lls += [float(x) for x in fit["lls"]]
    ll = model.log_likelihood()
    n_edges = int(model.A.sum())
    print(f"  warm-up {N_WARMUP} sweeps: {warm:.3f} s; "
          f"{N_TIMED} timed sweeps: {dt:.3f} s = "
          f"{N_TIMED / dt:.4f} sweeps/s (precision='high')")
    print(f"  log-likelihood per sweep: {[round(x, 1) for x in lls]}")
    print(f"  final log_likelihood() = {ll:.1f} (truth: "
          f"{truth.log_likelihood(Y):.1f}); edges {n_edges}; link AUC of "
          f"the {N_TIMED}-sample mean = {link_auc(fit['A'].mean(0), truth.A):.4f}")
    print(f"  launches over the main path: {launches}")
    n_sweeps = N_WARMUP + N_TIMED
    check(math.isfinite(ll) and all(math.isfinite(x) for x in lls),
          "log-likelihoods finite")
    check(lls[-1] > lls[0], "log-likelihood rose over the run")
    check(fit["A"].shape == (N_TIMED, N, N)
          and np.isfinite(fit["W"]).all(), "samples finite, shapes right")
    check(launches["pg_devroye"] >= n_sweeps, f"K1 launched >= {n_sweeps}")
    for k in ("ss_group_pass", "ss_edge_scan"):
        check(launches[k] >= n_sweeps * (N // G),
              f"{k} launched >= {n_sweeps * (N // G)}")
    check(launches["pg_gamma_series"] == 0 and launches["crt_sample"] == 0,
          "K4 and K5 not launched by the Bernoulli sweep")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    return {"sweeps_per_s": N_TIMED / dt, "generate_s": gen_s}


def phase_nb_slice(check, record):
    """The NB flagship (benchmarks/common.py) through the user entry points,
    and the launch counts of that run; then one dispersion update without
    the count table, which runs K5."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseNegativeBinomialGLM
    from pyglm_tpu_torch.models.weights import pack_weights
    from pyglm_tpu_torch.ops import _build

    print(f"NB slice: truth model N={N}, generate T={T}", flush=True)
    truth = SparseNegativeBinomialGLM(N, B=B, L=L, seed=42,
                                      net_kwargs=NB_TRUTH_NET,
                                      obs_kwargs=NB_OBS, device="cuda")
    t0 = time.perf_counter()
    Y = np.minimum(truth.generate(T, keep=False), 15.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"  generate: {gen_s:.2f} s, mean count {Y.mean():.4f}/bin, "
          f"{(Y > 0).mean():.4f} of bins nonzero, max {Y.max():.0f}, "
          f"{int(truth.A.sum())} true edges")

    model = SparseNegativeBinomialGLM(N, B=B, L=L, seed=0, precision="high",
                                      obs_kwargs=NB_OBS, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    model.add_data(Y)
    torch.cuda.synchronize()
    print(f"  add_data: {time.perf_counter() - t0:.3f} s")
    lls = []
    t0 = time.perf_counter()
    for _ in range(N_WARMUP):
        lls.append(model.resample_model()["log_likelihood"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = model.fit(n_samples=N_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    lls += [float(x) for x in fit["lls"]]
    ll = model.log_likelihood()
    r = model.state.aux["r"]
    n_edges = int(model.A.sum())
    print(f"  warm-up {N_WARMUP} sweeps: {warm:.3f} s; "
          f"{N_TIMED} timed sweeps: {dt:.3f} s = "
          f"{N_TIMED / dt:.4f} sweeps/s (precision='high')")
    print(f"  log-likelihood per sweep: {[round(x, 1) for x in lls]}")
    print(f"  final log_likelihood() = {ll:.1f} (truth: "
          f"{truth.log_likelihood(Y):.1f}); mean r {float(r.mean()):.4f} "
          f"(truth 4.0), range [{float(r.min()):.4f}, {float(r.max()):.4f}]"
          f"; edges {n_edges} (truth {int(truth.A.sum())})")
    print(f"  launches over the NB main path: {launches}")
    n_sweeps = N_WARMUP + N_TIMED
    check(math.isfinite(ll) and all(math.isfinite(x) for x in lls),
          "NB log-likelihoods finite")
    check(lls[-1] > lls[0], "NB log-likelihood rose over the run")
    check(bool(torch.isfinite(r).all() and (r > 0).all()),
          "NB r finite and positive")
    check(launches["pg_gamma_series"] >= n_sweeps, f"K4 launched >= {n_sweeps}")
    for k in ("ss_group_pass", "ss_edge_scan"):
        check(launches[k] >= n_sweeps * (N // G),
              f"{k} launched >= {n_sweeps * (N // G)} in the NB run")
    check(launches["pg_devroye"] == 0, "K1 not launched by the NB sweep")
    for name in KERNELS:
        record[name]["launches"] += launches[name]

    d = model.datas[0]
    psi = d.Xf @ pack_weights(model.state.A, model.state.W, model.state.b)
    _build.reset_launches()
    aux = model.observation.resample_aux(model.generators.host,
                                         model.state.aux, d.Y, psi,
                                         cache=None)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    r2 = aux["r"]
    print(f"  r update without the count table: mean r "
          f"{float(r2.mean()):.4f}; launches {launches}")
    check(launches["crt_sample"] == 1
          and sum(launches.values()) == 1, "K5 launched exactly once")
    check(bool(torch.isfinite(r2).all() and (r2 > 0).all()),
          "r from the elementwise CRT finite and positive")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    return {"nb_sweeps_per_s": N_TIMED / dt, "nb_generate_s": gen_s}


def phase_small_parity(check, nb=False):
    """One spike-and-slab update on the card (K2 + K3) and on the CPU
    (plain) from the same state (r included for NB), PG draws and noise.
    The PG draws come from the card: K1 for Bernoulli, K4 for NB."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM, SparseNegativeBinomialGLM
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, pack_weights, resample_spike_slab_tspace)
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    n, t, g = 20, 5000, 5
    print(f"small {'NB' if nb else 'Bernoulli'} slice: card vs CPU, N={n}, "
          f"T={t}, G={g}", flush=True)
    if nb:
        cls, kw = SparseNegativeBinomialGLM, dict(obs_kwargs=NB_OBS)
        truth = cls(n, seed=3, net_kwargs=NB_TRUTH_NET | dict(
            rho_init=0.2, mu_bias=-1.0), **kw)
        Y = np.minimum(truth.generate(t, keep=False), 15.0)
    else:
        cls, kw = SparseBernoulliGLM, {}
        truth = cls(n, seed=3, net_kwargs=TRUTH_NET | dict(
            rho_init=0.2, mu_bias=-1.5))
        Y = truth.generate(t, keep=False)
    mc = cls(n, seed=4, group=g, device="cuda", **kw)
    mh = cls(n, seed=4, group=g, device="cpu", **kw)
    mc.add_data(Y)
    mh.add_data(Y)
    mc.fit(n_samples=3)
    s = state_to_numpy(mc.state)
    mh.state = state_from_numpy(s["A"], s["W"], s["b"], s["net"],
                                aux=s["aux"])
    xerr = float((mc.datas[0].Xf.cpu() - mh.datas[0].Xf).abs().max())
    check(xerr <= 1e-6, f"design on card vs CPU: max|diff| = {xerr:.2e}")
    if nb:
        same = torch.equal(mc.datas[0].llc["counts"].cpu(),
                           mh.datas[0].llc["counts"])
        check(same, "NB count table on card identical to CPU")
    llc, llh = mc.log_likelihood(), mh.log_likelihood()
    check(abs(llc - llh) <= 1e-5 * abs(llh),
          f"log_likelihood card {llc:.3f} vs CPU {llh:.3f}")

    hyp_c = mc.network.edge_hypers(mc.state.net, "cuda")
    hyp_h = mh.network.edge_hypers(mh.state.net, "cpu")
    w_c = pack_weights(mc.state.A, mc.state.W, mc.state.b)
    w_h = pack_weights(mh.state.A, mh.state.W, mh.state.b)
    psi_c = mc.datas[0].Xf @ w_c
    omega_c, kappa_c = mc.observation.omega_kappa(
        mc.generators.host, mc.datas[0].Y, psi_c, mc.state.aux)
    psi_h = mh.datas[0].Xf @ w_h
    kappa_h = mh.observation.omega_kappa(
        torch.Generator().manual_seed(0), mh.datas[0].Y, psi_h,
        mh.state.aux)[1]
    gen = torch.Generator().manual_seed(5)
    ng = n // g
    noise = SpikeSlabNoise(torch.rand((ng, g, n), generator=gen),
                           torch.randn((ng, g, n, 4), generator=gen),
                           torch.randn((n,), generator=gen))
    noise_c = SpikeSlabNoise(*(x.cuda() for x in noise))
    out_c = resample_spike_slab_tspace(
        None, mc.datas[0].Xt, omega_c, kappa_c, psi_c, w_c,
        hyp_c, 4, group=g, noise=noise_c)
    omega_h = omega_c.cpu()
    out_h = resample_spike_slab_tspace(
        None, mh.datas[0].Xt, omega_h, kappa_h, psi_h, w_h,
        hyp_h, 4, group=g, noise=noise)
    n_diff = int((out_c[0].cpu() != out_h[0]).sum())
    check(n_diff == 0, f"A identical ({n_diff} of {n * n} differ)")
    # Relative to the largest weight: the card sums M0 and the Gram over
    # time in another order than the CPU's BLAS.
    werr = rel_err(out_c[1].cpu(), out_h[1])
    uerr = float((out_c[2].cpu() - out_h[2]).abs().max())
    w_tol, u_tol = REL_TOL, 1e-3
    if nb:
        # NB's omega (up to ~10) makes the collinear basis features' posterior
        # ~10x more sensitive to float32 rounding than Bernoulli's: measure
        # that on the CPU (psi rounded from float64 instead of a float32
        # GEMM) and allow 10x it.
        psi64 = (mh.datas[0].Xf.double() @ w_h.double()).float()
        out_64 = resample_spike_slab_tspace(
            None, mh.datas[0].Xt, omega_h, kappa_h, psi64, w_h,
            hyp_h, 4, group=g, noise=noise)
        sens_w = rel_err(out_64[1], out_h[1])
        sens_u = float((out_64[2] - out_h[2]).abs().max())
        print(f"  CPU's own sensitivity to rounding psi: w {sens_w:.2e}, "
              f"u {sens_u:.2e}")
        w_tol, u_tol = max(w_tol, 10 * sens_w), max(u_tol, 10 * sens_u)
    check(werr <= w_tol, f"w_full max|diff|/max|w| = {werr:.2e} "
          f"(max|w| = {float(out_h[1].abs().max()):.3f}; limit {w_tol:.2e})")
    check(uerr <= u_tol, f"u max|diff| = {uerr:.2e} (limit {u_tol:.2e})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from pyglm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: pyglm_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    build_s = _build.build(force=True)
    print(f"kernels built in {build_s:.2f} s -> {_build.LIB_PATH}")
    for line in _build.LOG_PATH.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()

    check = Checks()
    record = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0}
              for name, (src, rep) in KERNELS.items()}
    summary = {}
    for phase in (lambda: phase_kernels(check, record),
                  lambda: phase_kernels_nb(check, record),
                  lambda: summary.update(phase_slice(check, record)),
                  lambda: summary.update(phase_nb_slice(check, record)),
                  lambda: phase_small_parity(check),
                  lambda: phase_small_parity(check, nb=True)):
        try:
            phase()
        except Exception:                      # recorded; the run fails
            traceback.print_exc()
            check(False, "phase raised")
    check("jax" not in sys.modules, "JAX was not imported")
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: "
              f"{check.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"build_s": build_s, **summary}))
    print(card_line())
    print(json.dumps({"kernels": list(record.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
