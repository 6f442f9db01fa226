#!/usr/bin/env python3
"""Smoke test of pyglm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc and PyTorch built for CUDA; it imports nothing of JAX.

  0. Pre-flight: CUDA must be present (else exit 2). Prints the card's name
     and power limit and builds the kernels from ``pyglm_tpu_torch/csrc``.
  1. Kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the flagship's shapes (N=200, T=100k, B=4, G=8), with the
     median time of each.
  2. Slice: a ground-truth SparseBernoulliGLM(200, B=4, L=10) generates
     T=100k bins; a fresh model fits them (2 warm-up + 5 timed sweeps),
     and every kernel's launch count over that run is checked. Then a small
     model on the card is held against the same model on the CPU: same
     state, same PG draws and noise, same result.

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
    for name in KERNELS:
        record[name]["launches"] = launches[name]
    return {"sweeps_per_s": N_TIMED / dt, "generate_s": gen_s}


def phase_small_parity(check):
    """One spike-and-slab update on the card (K2 + K3) and on the CPU
    (plain) from the same state, PG draws and noise."""
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, pack_weights, resample_spike_slab_tspace)
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    n, t, g = 20, 5000, 5
    print(f"small slice: card vs CPU, N={n}, T={t}, G={g}", flush=True)
    truth = SparseBernoulliGLM(n, seed=3, net_kwargs=TRUTH_NET | dict(
        rho_init=0.2, mu_bias=-1.5))
    Y = truth.generate(t, keep=False)
    mc = SparseBernoulliGLM(n, seed=4, group=g, device="cuda")
    mh = SparseBernoulliGLM(n, seed=4, group=g, device="cpu")
    mc.add_data(Y)
    mh.add_data(Y)
    mc.fit(n_samples=3)
    s = state_to_numpy(mc.state)
    mh.state = state_from_numpy(s["A"], s["W"], s["b"], s["net"])
    xerr = float((mc.datas[0].Xf.cpu() - mh.datas[0].Xf).abs().max())
    check(xerr <= 1e-6, f"design on card vs CPU: max|diff| = {xerr:.2e}")
    llc, llh = mc.log_likelihood(), mh.log_likelihood()
    check(abs(llc - llh) <= 1e-5 * abs(llh),
          f"log_likelihood card {llc:.3f} vs CPU {llh:.3f}")

    hyp_c = mc.network.edge_hypers(mc.state.net, "cuda")
    hyp_h = mh.network.edge_hypers(mh.state.net, "cpu")
    w_c = pack_weights(mc.state.A, mc.state.W, mc.state.b)
    w_h = pack_weights(mh.state.A, mh.state.W, mh.state.b)
    psi_c = mc.datas[0].Xf @ w_c
    omega_c = mc.observation.omega_kappa(mc.generators.host,
                                         mc.datas[0].Y, psi_c, None)[0]
    gen = torch.Generator().manual_seed(5)
    ng = n // g
    noise = SpikeSlabNoise(torch.rand((ng, g, n), generator=gen),
                           torch.randn((ng, g, n, 4), generator=gen),
                           torch.randn((n,), generator=gen))
    noise_c = SpikeSlabNoise(*(x.cuda() for x in noise))
    kappa_h = mh.datas[0].Y - 0.5
    out_c = resample_spike_slab_tspace(
        None, mc.datas[0].Xt, omega_c, mc.datas[0].Y - 0.5, psi_c, w_c,
        hyp_c, 4, group=g, noise=noise_c)
    omega_h = omega_c.cpu()
    out_h = resample_spike_slab_tspace(
        None, mh.datas[0].Xt, omega_h, kappa_h, mh.datas[0].Xf @ w_h, w_h,
        hyp_h, 4, group=g, noise=noise)
    n_diff = int((out_c[0].cpu() != out_h[0]).sum())
    check(n_diff == 0, f"A identical ({n_diff} of {n * n} differ)")
    # Relative to the largest weight: the card sums M0 and the Gram over
    # time in another order than the CPU's BLAS.
    werr = rel_err(out_c[1].cpu(), out_h[1])
    uerr = float((out_c[2].cpu() - out_h[2]).abs().max())
    check(werr <= REL_TOL, f"w_full max|diff|/max|w| = {werr:.2e} "
          f"(max|w| = {float(out_h[1].abs().max()):.3f})")
    check(uerr <= 1e-3, f"u max|diff| = {uerr:.2e}")


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
                  lambda: summary.update(phase_slice(check, record)),
                  lambda: phase_small_parity(check)):
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
