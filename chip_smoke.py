#!/usr/bin/env python3
"""Smoke test of pyglm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, nvcc and PyTorch built for CUDA; it imports nothing of JAX.

  0. Pre-flight: CUDA must be present (else exit 2). Prints the card's name
     and power limit and builds the kernels from ``pyglm_tpu_torch/csrc``
     (one nvcc per source, in parallel).
  1. Kernels: each hand-written kernel body against its plain PyTorch
     version on the card, with the device time of each (CUDA events around
     a run of calls), of its plain version and, where one PyTorch call
     computes the same function, of that call: at the flagships' shapes
     (N=200, T=100k, B=4, G=8) K1-K3 (K2's Gram in 3xTF32 on the tensor
     cores, timed at g = 0 and at a middle group; then in one bf16 pass
     ("default") and on a stochastically rounded Z ("sr", on the same
     rounding words as its plain version), both on wgmma over the bf16
     omega stream, the Gram kernel alone also timed by torch.profiler),
     K2's SR Gram at a small shape
     (unbiased over 256 seeds), then the NB kernels K4 (gamma-series PG;
     its bound from a count of the special-function operations its
     proposals need at the SFU's rate) and K5 (CRT counts); at the 8-chain
     latent-distance ensemble's shapes (P=2001, T=20k, 4000 lanes, G=10)
     K6 (group Gram) at precision "high" (3xTF32), "highest" (fp32 FMA)
     and "default" (one bf16 pass on wgmma over a bf16 omega stream), plus
     a small ragged shape, then K3 on that "high" Gram, one call per group
     in the staged loop's order (cold from device memory), with a
     non-identity Lam0 and a nonzero mu0; and K6's fp32 body also at the
     flagship's shape (Xt (801, 100000), omega (100000, 200), G=8: the
     staged loop's call at "highest"). K2's and K6's Grams and their plain
     versions are also held against a float64 Gram of their operands. K3's
     times are device times by torch.profiler (its host work per call
     exceeds the kernel's).
  2. Slices, each run with the launch counts set to 0 just before and read
     just after: a ground-truth SparseBernoulliGLM(200, B=4, L=10)
     generates T=100k bins and a fresh model fits them (2 warm-up + 5 timed
     sweeps) and one update at "high" with TF32 switched on globally
     (unchanged: the sweep pins its GEMMs), then the same data at
     precision="highest" (the staged loop
     with K6's fp32 body, no K2), "default" and "sr" (the fused loop on
     K2's bf16 and SR Grams); the same for SparseNegativeBinomialGLM
     (max_y=16, counts
     capped at 15), followed by one NB dispersion update without the count
     table, which runs K5; then the acceptance suite's config 5
     (latent-distance prior, N=500, T=20k) through fit_ensemble with 8
     lane-stacked chains, a short collect="samples" run and a timed
     collect="mean" run on the staged loop (K6 + K3), and 5 stacked sweeps
     at precision="default" (K6's bf16 wgmma body). Then: the staged and
     the fused loop on one update at the ensemble's width with the same
     noise; small models on the card held against the same models on the
     CPU (Bernoulli at "high", "default" and "sr" and NB on the fused
     loop, 2 stacked chains on the staged loop at "high" and "highest"):
     same state, same PG draws and noise, same result; the latent-distance
     HMC on the card against the CPU with the same noise; and the chains of
     benchmarks/sr_parity.py (N=8, T=1500, 150 + 400 sweeps) at "default"
     and "sr" against a "high" chain, within a band set by a second "high"
     pool (the control).

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
GRAM_REL_TOL = 1e-5      # K6: fp32 sums over 2e4 terms in another order
# K2 "sr" against its plain version on the same rounding words: exact bf16
# products, fp32 sums in another order (another seed's words differ by more).
SR_SAME_TOL = 1e-5
# Acceptance config 5 (benchmarks/acceptance.py): latent-distance prior,
# pooled ensemble of 8 lane-stacked chains.
N5, T5, C5, G5 = 500, 20_000, 8, 10
C5_TRUTH_NET = dict(dim=2, mu_bias=-3.0)
# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
# The special-function unit (log, exp, sqrt, reciprocal, sin, cos, atan):
# 16 results per clock per SM on sm_90 (CUDA C++ Programming Guide,
# arithmetic instruction throughput), x 132 SMs x the SM clock's maximum.
SFU_PER_CLK_SM, H100_SMS = 16, 132
# A 3xTF32 Gram may be at most this many times further from a float64 Gram
# than the fp32 plain version (cuBLAS SGEMM on the materialised Z).
F64_RATIO = 2.0

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
    "group_gram": ("pyglm_tpu_torch/csrc/group_gram.cu",
                   "pyglm_tpu/ops/gram_pallas.py:63"),
    # The bf16 Gram bodies, each its own record (LAUNCHES key).
    "ss_group_pass_bf16": ("pyglm_tpu_torch/csrc/gram_wgmma.cuh",
                           "pyglm_tpu/ops/ss_pallas.py:343"),
    "ss_group_pass_sr": ("pyglm_tpu_torch/csrc/gram_wgmma.cuh",
                         "pyglm_tpu/ops/ss_pallas.py:346"),
    "group_gram_bf16": ("pyglm_tpu_torch/csrc/group_gram.cu",
                        "pyglm_tpu/ops/gram_pallas.py:47"),
}
# Fields every kernel's record must carry; library_ms may be null.
RECORD_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


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
    """Median host time of `reps` calls, each between two synchronisations
    (how PR 1-3 timed every kernel)."""
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


def event_ms(fn, reps):
    """Device time per call: CUDA events around `reps` calls in a row after
    a warm-up call, so the host's time to enqueue overlaps the device's."""
    import torch
    fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes, *work):
    """The least time the card could take: the larger of the bytes a call
    must move (each input read once, each output written once) over the
    HBM rate and its operations over the peak of the arithmetic they use,
    summed over `work`, (operations, peak) pairs (a 3xTF32 product counts
    3x its operations at the TF32 peak). (ms, bound_by)."""
    tb, tf = nbytes / HBM_BYTES_S, sum(ops / peak for ops, peak in work)
    return {"bound_ms": 1e3 * max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations"}


def sfu_rate() -> float:
    """Special-function results per second of the card: SFU_PER_CLK_SM x
    H100_SMS x the SM clock's maximum, as nvidia-smi reads it."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    return SFU_PER_CLK_SM * H100_SMS * mhz * 1e6


def mt_rates(shape):
    """Per Marsaglia-Tsang proposal for Gamma(shape), shape >= 1: the
    acceptance probability and the probability that K4's two squeezes (u <
    1 - 0.0331 x^4, u < 1 - x^4 / (100 d min(1, v0))) miss and the two logs
    run, by quadrature over the proposal normal x (numpy arrays,
    interpolated in log shape)."""
    import numpy as np
    grid = np.geomspace(1.0, 1e5, 500)
    x = np.linspace(-12.0, 12.0, 12001)
    phi = np.exp(-0.5 * x * x) / math.sqrt(2 * math.pi) * (x[1] - x[0])
    d = grid[:, None] - 1.0 / 3.0
    v0 = 1.0 + x[None, :] / (3.0 * np.sqrt(d))
    ok = v0 > 0
    v = np.where(ok, v0, 1.0) ** 3
    log_ratio = 0.5 * x * x + d - d * v + d * np.log(v)
    acc = (phi * ok * np.exp(np.minimum(log_ratio, 0.0))).sum(1)
    squeeze = np.minimum(0.0331, 0.01 / (d * np.clip(v0, 1e-30, 1.0)))
    miss = (phi * ok * np.minimum(1.0, squeeze * x ** 4)).sum(1)
    ls = np.log(shape)
    return (np.interp(ls, np.log(grid), acc),
            np.interp(ls, np.log(grid), miss))


def k4_sfu_ops(b, c, cutoff):
    """Special-function operations for these inputs, summed over the
    elements: (law, algorithm). `law` counts only what any exact sampler of
    PG(b, c) must do from these inputs: per series element the 4 weights'
    reciprocals, beta's division and reciprocal (2) and the tail sums (a
    reciprocal below a = 0.5, else also an atan and 6 divisions); per
    normal-regime element its moments (tanh, sqrt and 3 divisions: 5).
    `algorithm` adds what K4's own sampler (csrc/pg_gamma.cu) spends, in
    expectation over its proposals: per series element one proposal
    stream, 4 / p_s proposals at the series' shape (acceptance p_s), then
    1 / p_t at the tail's, in Box-Muller pairs of 4 operations (log, sqrt,
    sin, cos; the stream ends on a whole pair), 2 logs for each proposal
    the squeeze misses, the two shapes' 1/sqrt(9 d) (2), and a boost (log,
    exp, division: 3) for each draw whose shape is below 1; per
    normal-regime element a Box-Muller pair (4). Another normal generator
    (a ziggurat) would spend no special function on the normals, so only
    `law` bounds the function."""
    import numpy as np
    from pyglm_tpu_torch.ops.polyagamma import _tail_sums
    b, c = b.flatten(), c.flatten()
    normal = b >= cutoff
    ser = (b > 0) & ~normal
    bp = b[ser].clamp_min(1e-6).double()
    a = c[ser].abs().double() / (2 * math.pi)
    S1, S2, S3 = _tail_sums(a.float(), 4)
    tpp = 2 * math.pi ** 2
    v_t = bp * S2.double() / (4 * math.pi ** 4)
    mu3 = 2 * bp * S3.double() / tpp ** 3
    beta = 2 * v_t / mu3.clamp_min(1e-30)
    alpha = (v_t * beta * beta).cpu().numpy()
    bp, a = bp.cpu().numpy(), a.cpu().numpy()
    p_s, miss_s = mt_rates(np.where(bp < 1, bp + 1, bp))
    p_t, miss_t = mt_rates(np.where(alpha < 1, alpha + 1, alpha))
    prop_s, prop_t = 4.0 / p_s, 1.0 / p_t
    law = 4 + 2 + np.where(a < 0.5, 1.0, 8.0)
    algo = (4.0 * ((prop_s + prop_t) / 2 + 0.25)
            + 2.0 * (miss_s * prop_s + miss_t * prop_t) + 2
            + 12.0 * (bp < 1) + 3.0 * (alpha < 1))
    n_normal = int(normal.sum())
    law_ops = float(law.sum()) + 5.0 * n_normal
    return law_ops, law_ops + float(algo.sum()) + 4.0 * n_normal


def k3_bound(G_, B_, lanes):
    """K3's bound for one group: the packed Gram, M0, w in and out, dW,
    priors, noise and a; per edge and lane the m update, a B x B Cholesky
    and three triangular solves."""
    GB = G_ * B_
    npair = GB * (GB + 1) // 2
    return bound(4 * lanes * (npair + 4 * GB
                              + G_ * (B_ + B_ * B_ + 3 + B_)),
                 (G_ * lanes * (2 * B_ * GB + 6 * B_ * B_ + B_ ** 3),
                  FP32_FLOPS))


def kernel_ms(fn, reps, match):
    """Device time per call of the kernels whose names hold `match`, over
    `reps` calls traced by torch.profiler (after one untraced call)."""
    from pyglm_tpu_torch.diagnostics.timing import device_ms
    return sum(t for k, t in device_ms(fn, reps).items() if match in k)


def bf16_matmul_ms(Z, om, reps):
    """The library call of a bf16 Gram: cuBLAS on the materialised Z and
    omega in bf16, with an fp32 output where torch.mm offers one
    (``out_dtype``), else a bf16 output. (ms, output dtype)."""
    import torch
    a, b = Z.to(torch.bfloat16), om.to(torch.bfloat16)
    try:
        torch.mm(a[:16], b, out_dtype=torch.float32)
        fn, out = (lambda: torch.mm(a, b, out_dtype=torch.float32)), "fp32"
    except TypeError:
        fn, out = (lambda: torch.mm(a, b)), "bf16"
    return event_ms(fn, reps), out


def phase_kernels(check, record):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch.ops.basis import design_matrix, cosine_basis
    from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
    from pyglm_tpu_torch.ops.polyagamma import (
        pg_devroye_plain, pg_mean, pg_var)
    from pyglm_tpu_torch.ops.ss_cuda import (
        omega_bf16_stream, pair_index, sr_round, sr_words, ss_edge_scan_cuda,
        ss_edge_scan_plain, ss_group_pass_cuda, ss_group_pass_plain, to_bf16)

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
    # c = 3.0 and 3.25 straddle the switch from the tilted Levy to the
    # Michael-Schucany-Haas proposal at z t = 1 (c = 3.125).
    for c in (0.0, 0.5, 2.0, 3.0, 3.25, 8.0, 30.0):
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
        se = math.sqrt(float(pg_var(1.0, c)) / cv.numel())
        zc = (float(k.double().mean()) - float(pg_mean(1.0, c))) / se
        check(abs(zc) < 5.0, f"K1 mean at c={c} vs pg_mean: {zc:.2f} "
              "standard errors (|z| < 5)")
    ms = event_ms(lambda: pg_devroye_cuda(psi, 3, 0), 10)
    plain_ms = event_ms(lambda: pg_devroye_plain(psi, gen), 3)
    # Config 5's draws: (T5, 8 chains x N5).
    psi5 = -2.5 + 2.0 * torch.randn((T5, C5 * N5), generator=gen,
                                    device=dev)
    ms5 = event_ms(lambda: pg_devroye_cuda(psi5, 4, 0), 10)
    del psi5
    # psi in, omega out; at least ~10 fp32 operations per draw (one
    # proposal and its test), so the bytes set the bound.
    record["pg_devroye"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                library_ms=None, config5_ms=ms5,
                                **bound(2 * 4 * T * N,
                                        (10 * T * N, FP32_FLOPS)))
    print(f"  K1 {ms:.3f} ms, plain {plain_ms:.3f} ms; at ({T5}, "
          f"{C5 * N5}) {ms5:.3f} ms (max_abs_err = largest |mean diff| "
          f"over the seven c)")

    # --- K2: one group pass at GB=32, T=100k, N=200 -----------------------
    print("K2 ss_group_pass: group g=3 of 25, GB=32, 3xTF32 Gram; then "
          "the bf16 and SR Grams", flush=True)
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
    high_plain = out_p
    again = ss_group_pass_cuda(xp, xg, omega, u0.clone(), dw, True)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "K2 repeats bit for bit")
    p_idx, q_idx = pair_index(GB, dev)
    Z = xg[p_idx] * xg[q_idx]
    j64 = Z.double() @ omega.double()
    e_k, e_p = rel_err(out_k[1].double(), j64), rel_err(out_p[1].double(), j64)
    del j64, again
    check(e_k <= F64_RATIO * e_p,
          f"K2 Gram (3xTF32) vs a float64 Gram: {e_k:.2e}; the fp32 plain "
          f"version: {e_p:.2e} (limit {F64_RATIO:g}x)")
    ms = event_ms(lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw), 20)
    ms_g0 = event_ms(lambda: ss_group_pass_cuda(None, xg, omega, u_k, dw,
                                                True), 20)
    host_ms = median_ms(lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw),
                        10)
    plain_ms = event_ms(lambda: ss_group_pass_plain(xp, xg, omega, u_p, dw),
                         5)
    lib_ms = event_ms(lambda: torch.matmul(Z, omega), 10)
    npair = GB * (GB + 1) // 2
    # xp, xg, omega, u in and out, dw; M0, packed Gram, sum omega out. The
    # Gram's and the gather's FMAs as three TF32 products at the tensor
    # cores' peak (precision "high"), the scatter's in fp32.
    k2_bytes = 4 * (2 * GB * T + 3 * T * N + GB * N + (GB + npair + 1) * N)
    m0_scatter = ((3 * 2 * T * N * GB, TF32_FLOPS),
                  (2 * T * N * GB, FP32_FLOPS))
    record["ss_group_pass"].update(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        precision="high", ms_g0=ms_g0, host_ms=host_ms, f64_rel_err=e_k,
        plain_f64_rel_err=e_p,
        **bound(k2_bytes, (3 * 2 * T * N * npair, TF32_FLOPS), *m0_scatter))
    rec = record["ss_group_pass"]
    print(f"  K2 {ms:.3f} ms per middle group, {ms_g0:.3f} at g = 0 (no "
          f"scatter); {host_ms:.3f} ms per synchronised call on the host "
          f"clock; plain {plain_ms:.3f} ms, library (fp32 "
          f"matmul on the materialised Z) {lib_ms:.3f} ms; bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, 3xTF32)")

    # --- K2 "default" and "sr" at the same group, on omega rounded to
    # bf16 as the fused loop gives it (ss_pallas.py:409-413), with its bf16
    # stream made once, as the fused loop makes it once per update (the
    # Gram's wgmma body reads the stream; the scatter the fp32 omega) ------
    om16 = to_bf16(omega)
    om_s = omega_bf16_stream(om16)
    u_k, u_p = u0.clone(), u0.clone()
    out_k = ss_group_pass_cuda(xp, xg, om16, u_k, dw, True,
                               precision="default", om16=om_s)
    out_p = ss_group_pass_plain(xp, xg, om16, u_p, dw, True,
                                precision="default")
    torch.cuda.synchronize()
    errs = {"u": rel_err(u_k, u_p)}
    for name, a, b in zip(("M0", "Jgg", "sum_omega"), out_k, out_p):
        errs[name] = rel_err(a, b)
    for name, e in errs.items():
        check(e <= REL_TOL, f"K2 default {name}: max|diff|/max|plain| = "
              f"{e:.2e}")
    max_abs = max(float((a - b).abs().max())
                  for a, b in [(u_k, u_p), *zip(out_k, out_p)])
    j64 = to_bf16(Z).double() @ om16.double()
    e_k, e_p = rel_err(out_k[1].double(), j64), rel_err(out_p[1].double(), j64)
    del j64
    check(e_k <= F64_RATIO * e_p,
          f"K2 Gram (bf16) vs a float64 Gram of the bf16 operands: "
          f"{e_k:.2e}; the plain version: {e_p:.2e} (limit {F64_RATIO:g}x)")
    again = ss_group_pass_cuda(xp, xg, om16, u0.clone(), dw, True,
                               precision="default", om16=om_s)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "K2 default repeats bit for bit")
    del again
    record["ss_group_pass_bf16"].update(max_abs_err=max_abs, f64_rel_err=e_k,
                                        plain_f64_rel_err=e_p)

    # "sr" at the same group against its plain version on the kernel's own
    # Philox words (sr_words repeats the draw); another seed's words differ.
    sr_seed = (5, 6)
    r16 = sr_words(*sr_seed, npair, T).to(dev)
    u_k, u_p = u0.clone(), u0.clone()
    out_k = ss_group_pass_cuda(xp, xg, om16, u_k, dw, True, precision="sr",
                               sr_seed=sr_seed, om16=om_s)
    out_p = ss_group_pass_plain(xp, xg, om16, u_p, dw, True, precision="sr",
                                r16=r16)
    other = ss_group_pass_cuda(xp, xg, om16, u0.clone(), dw, precision="sr",
                               sr_seed=(sr_seed[0] + 1, sr_seed[1]),
                               om16=om_s)[1]
    again = ss_group_pass_cuda(xp, xg, om16, u0.clone(), dw, True,
                               precision="sr", sr_seed=sr_seed, om16=om_s)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "K2 sr repeats bit for bit")
    del again
    torch.cuda.synchronize()
    errs = {"u": rel_err(u_k, u_p)}
    for name, a, b in zip(("M0", "Jgg", "sum_omega"), out_k, out_p):
        errs[name] = rel_err(a, b)
    for name, e in errs.items():
        check(e <= SR_SAME_TOL, f"K2 sr {name} on the same words: "
              f"max|diff|/max|plain| = {e:.2e} (limit {SR_SAME_TOL:.0e})")
    e_other = rel_err(other, out_p[1])
    check(e_other > SR_SAME_TOL, f"K2 sr Jgg on another seed's words: "
          f"{e_other:.2e} (must exceed {SR_SAME_TOL:.0e})")
    max_abs = max(float((a - b).abs().max())
                  for a, b in [(u_k, u_p), *zip(out_k, out_p)])
    j64 = sr_round(Z, r16).double() @ om16.double()
    e_k, e_p = rel_err(out_k[1].double(), j64), rel_err(out_p[1].double(), j64)
    del j64, other
    check(e_k <= F64_RATIO * e_p,
          f"K2 Gram (sr) vs a float64 Gram of the same rounded operands: "
          f"{e_k:.2e}; the plain version: {e_p:.2e} (limit {F64_RATIO:g}x)")
    record["ss_group_pass_sr"].update(max_abs_err=max_abs, f64_rel_err=e_k,
                                      plain_f64_rel_err=e_p)

    times, gram_ms = {}, {}
    for prec in ("default", "sr", "sr", "default"):
        times.setdefault(prec, []).append(event_ms(
            lambda: ss_group_pass_cuda(xp, xg, om16, u_k, dw, precision=prec,
                                       sr_seed=sr_seed, om16=om_s), 20))
    for prec, inst in (("default", "<false>"), ("sr", "<true>")):
        gram_ms[prec] = kernel_ms(
            lambda: ss_group_pass_cuda(xp, xg, om16, u_k, dw, precision=prec,
                                       sr_seed=sr_seed, om16=om_s), 20,
            f"group_pass_wgmma_kernel{inst}")
        check(gram_ms[prec] > 0,
              f"K2 {prec}: the profiler saw its wgmma Gram kernel")
    plain_ms = event_ms(lambda: ss_group_pass_plain(
        xp, xg, om16, u_p, dw, precision="default"), 5)
    plain_sr_ms = event_ms(lambda: ss_group_pass_plain(
        xp, xg, om16, u_p, dw, precision="sr", r16=r16), 5)
    del r16
    lib_ms, lib_out = bf16_matmul_ms(to_bf16(Z), om16, 10)
    del Z
    # The bf16 Gram over the bf16 peak; M0 3xTF32 and the scatter fp32.
    # The Gram alone: X_g and the bf16 omega stream in, the packed Gram out.
    k2_bound = bound(k2_bytes, (2 * T * N * npair, BF16_FLOPS), *m0_scatter)
    gram_bound = bound(4 * GB * T + 2 * om_s.numel() + 4 * npair * N,
                       (2 * T * N * npair, BF16_FLOPS))
    for key, prec, pms in (("ss_group_pass_bf16", "default", plain_ms),
                           ("ss_group_pass_sr", "sr", plain_sr_ms)):
        record[key].update(
            ms=min(times[prec]), plain_ms=pms, library_ms=lib_ms,
            library_out=lib_out, precision=prec, gram_ms=gram_ms[prec],
            gram_bound_ms=gram_bound["bound_ms"],
            gram_bound_by=gram_bound["bound_by"], **k2_bound)
    print(f"  K2 default {times['default']} ms, sr {times['sr']} ms per "
          f"middle group (order default, sr, sr, default); the Gram kernel "
          f"alone {gram_ms['default']:.4f} / {gram_ms['sr']:.4f} ms "
          f"(profiler; bound {gram_bound['bound_ms']:.4f} ms, "
          f"{gram_bound['bound_by']}); plain "
          f"{plain_ms:.3f} / {plain_sr_ms:.3f} ms; library (bf16 cuBLAS on "
          f"the materialised bf16 Z, {lib_out} output) {lib_ms:.3f} ms; "
          f"bound {k2_bound['bound_ms']:.3f} ms ({k2_bound['bound_by']})")
    phase_k2_sr(check, record, gen)

    # --- K3: that group's edge scan, same injected noise -----------------
    print("K3 ss_edge_scan: G=8 edges x 200 lanes, B=4", flush=True)
    m0, jgg = high_plain[0], high_plain[1]
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
    # K3's ms is device time by torch.profiler (see phase_k3_config5), warm
    # in L2 as after K2; before PR 10 it was CUDA events around back-to-back
    # calls, host included, as event_ms still is. ms_timer says which.
    w_t = w0.clone()
    ms = kernel_ms(lambda: ss_edge_scan_cuda(jgg, m0, w_t, mu, lam, lrho,
                                             u_a, eps), 20, "edge_scan_kernel")
    ev_ms = event_ms(lambda: ss_edge_scan_cuda(jgg, m0, w_t, mu, lam, lrho,
                                               u_a, eps), 20)
    plain_ms = event_ms(lambda: ss_edge_scan_plain(
        jgg, m0, w0.clone(), mu, lam, lrho, u_a, eps), 5)
    record["ss_edge_scan"].update(
        max_abs_err=max(werr, derr), ms=ms, plain_ms=plain_ms,
        library_ms=None, event_ms=ev_ms, ms_timer="torch.profiler device",
        **k3_bound(G, B, N))
    print(f"  K3 {ms:.4f} ms per group on the device ({ev_ms:.4f} ms per "
          f"call back to back, host included), plain {plain_ms:.3f} ms")


def phase_k2_sr(check, record, gen):
    """K2's SR Gram at a small shape (GB=32, T=4096, 256 lanes, a design of
    spikes and the cosine basis, bf16 omega): against its plain version on
    the same words (sr_words repeats the kernel's Philox draw; exact
    products, so only the sum order differs), unbiased over R launches
    with different seeds, below the "default" Gram's error on average, and
    repeatable for one seed."""
    import torch
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    from pyglm_tpu_torch.ops.ss_cuda import (
        pair_index, sr_words, ss_group_pass_cuda, ss_group_pass_plain,
        to_bf16)

    GB, Ts, Ns, R = 32, 4096, 256, 256
    print(f"K2 sr: GB={GB}, T={Ts}, {Ns} lanes, {R} seeds", flush=True)
    Y = (torch.rand((Ts, GB // B), generator=gen, device="cuda")
         < 0.15).float()
    X = design_matrix(Y, cosine_basis(B, L)).T.contiguous()[:GB]
    om = to_bf16(0.05 + 0.2 * torch.rand((Ts, Ns), generator=gen,
                                         device="cuda"))
    u = torch.zeros((Ts, Ns), device="cuda")
    npair = GB * (GB + 1) // 2

    def sr(seed, offset=7):
        return ss_group_pass_cuda(None, X, om, u, None, precision="sr",
                                  sr_seed=(seed, offset))[1]
    k = sr(99)
    p = ss_group_pass_plain(None, X, om, u, None, precision="sr",
                            r16=sr_words(99, 7, npair, Ts).cuda())[1]
    e_same, e_other = rel_err(k, p), rel_err(sr(100), p)
    check(e_same <= SR_SAME_TOL < e_other,
          f"K2 sr vs plain on the same words: {e_same:.2e} (limit "
          f"{SR_SAME_TOL:.0e}); on another seed's: {e_other:.2e}")
    check(torch.equal(k, sr(99)), "K2 sr repeats for one seed")
    pi, qi = pair_index(GB, "cuda")
    ref = (X[pi] * X[qi]).double() @ om.double()
    s1, s2 = torch.zeros_like(ref), torch.zeros_like(ref)
    for r in range(R):
        j = sr(1000 + r).double()
        s1 += j
        s2 += j * j
    mean = s1 / R
    se = ((s2 / R - mean ** 2).clamp_min(0) / (R - 1)).sqrt()
    live = se > 0
    z = float(((mean - ref).abs() / se)[live].max())
    dead = float((mean - ref)[~live].abs().max()) if bool(
        (~live).any()) else 0.0
    dflt = ss_group_pass_cuda(None, X, om, u, None,
                              precision="default")[1].double()
    rms_sr = float((mean - ref).pow(2).mean().sqrt())
    rms_one = float((k.double() - ref).pow(2).mean().sqrt())
    rms_default = float((dflt - ref).pow(2).mean().sqrt())
    check(z < 6.0 and dead <= 1e-6 * float(ref.abs().max()),
          f"K2 sr unbiased: max |z| of the {R}-launch mean vs the float64 "
          f"Gram = {z:.2f} over {int(live.sum())} cells (< 6)")
    check(rms_sr < 0.5 * rms_default,
          f"K2 sr RMS error: mean of {R} {rms_sr:.3e}, one launch "
          f"{rms_one:.3e}; default {rms_default:.3e} (mean < 0.5x default)")
    record["ss_group_pass_sr"].update(
        small_max_abs_err=float((k - p).abs().max()), sr_max_z=z,
        sr_rms_ratio=rms_sr / rms_default)


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
    ms = event_ms(lambda: pg_gamma_series_cuda(b, psi, 3, 0,
                                                normal_cutoff=170.0), 10)
    plain_ms = event_ms(lambda: pg_gamma_series_plain(b, psi, gen, 170.0), 3)
    # Bound: b and psi in, omega out, and the special-function operations
    # the law needs from these inputs at the SFU's rate (k4_sfu_ops).
    # sfu_algo_ms: those K4's own algorithm spends, at the same rate.
    (law_ops, algo_ops), rate = k4_sfu_ops(b, psi, 170.0), sfu_rate()
    k4b = bound(3 * 4 * T * N, (law_ops, rate))
    record["pg_gamma_series"].update(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
        law_ops_per_draw=law_ops / (T * N),
        sfu_ops_per_draw=algo_ops / (T * N), sfu_rate=rate,
        sfu_algo_ms=1e3 * algo_ops / rate, **k4b)
    print(f"  K4 {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(max_abs_err = largest |mean diff| over the grid); bound "
          f"{k4b['bound_ms']:.4f} ms ({k4b['bound_by']}; the law's "
          f"{law_ops / (T * N):.2f} special-function operations a draw at "
          f"{rate / 1e12:.3f}e12 a second: "
          f"{1e3 * law_ops / rate:.4f} ms); K4's algorithm spends "
          f"{algo_ops / (T * N):.2f} a draw, "
          f"{1e3 * algo_ops / rate:.4f} ms")

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
    ms = event_ms(lambda: crt_sample_cuda(yi, r, 16, 5, 0), 10)
    plain_ms = event_ms(lambda: crt_sample_plain(yi, r, 16, gen), 3)
    # y in and counts out (int32), r; the data's sum of min(y, max_y)
    # Bernoulli draws, ~3 operations each.
    record["crt_sample"].update(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(4 * (2 * T * N + N),
                (3 * float(yi.clamp(max=16).sum()), FP32_FLOPS)))
    print(f"  K5 {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"(max_abs_err = largest |mean diff| over the grid)")


def phase_slice(check, record, ctx):
    """The flagship through the user entry points: generate, add_data,
    resample_model, fit, log_likelihood; the launch counts of that run."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
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
    check(launches["pg_gamma_series"] == 0 and launches["crt_sample"] == 0
          and launches["group_gram"] == 0,
          "K4, K5 and K6 not launched by the Bernoulli sweep")
    check(weights.LAST_SS_PATH == "fused", "the flagship ran the fused loop")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    ctx["flagship_Y"] = Y
    # One update at "high" from the same state and generators with TF32
    # switched on globally (here only): the sweep pins its float32 GEMMs
    # (utils.fp32_matmul), so A, W and b must be those of TF32 off.
    from pyglm_tpu_torch.models.ensemble import chain_generators
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs.append(model._sweep(chain_generators(11, "cuda"),
                                     model.state, tuple(model.datas))[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(all(torch.equal(getattr(outs[0], k), getattr(outs[1], k))
              for k in ("A", "W", "b")),
          "the flagship update at 'high' is unchanged with TF32 switched on "
          "globally")
    return {"sweeps_per_s": N_TIMED / dt, "generate_s": gen_s}


def phase_highest(check, record, ctx):
    """The flagship's data at precision="highest": the staged loop with
    K6's fp32 body, never K2 (the JAX package's "highest" takes its staged
    path with the f32 XLA Gram)."""
    import math
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build

    print(f"flagship at precision='highest': N={N}, T={T}", flush=True)
    model = SparseBernoulliGLM(N, B=B, L=L, seed=0, precision="highest",
                               device="cuda")
    model.add_data(ctx["flagship_Y"])
    model.resample_model()                       # warm-up
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lls = [model.resample_model()["log_likelihood"] for _ in range(2)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"  2 sweeps in {dt:.3f} s = {2 / dt:.4f} sweeps/s; launches "
          f"{launches}; LAST_SS_PATH {weights.LAST_SS_PATH!r}")
    check(weights.LAST_SS_PATH == "staged",
          "precision='highest' ran the staged loop")
    check(launches["group_gram"] == 2 and launches["ss_group_pass"] == 0,
          "K6 once per sweep, K2 never")
    check(all(math.isfinite(x) for x in lls), "log-likelihoods finite")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    return {"highest_sweeps_per_s": 2 / dt}


def phase_bf16_flagship(check, record, ctx, precision):
    """The flagship's data at precision "default" or "sr" through fit():
    the fused loop on K2's bf16 or SR Gram. 2 warm-up sweeps, then the
    launch counts set to 0 and N_TIMED timed sweeps."""
    import math
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build

    key = {"default": "ss_group_pass_bf16", "sr": "ss_group_pass_sr"}[
        precision]
    print(f"flagship at precision={precision!r}: N={N}, T={T}", flush=True)
    model = SparseBernoulliGLM(N, B=B, L=L, seed=0, precision=precision,
                               device="cuda")
    model.add_data(ctx["flagship_Y"])
    lls = [model.resample_model()["log_likelihood"]
           for _ in range(N_WARMUP)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    fit = model.fit(n_samples=N_TIMED)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    lls += [float(x) for x in fit["lls"]]
    n_groups = N // G
    print(f"  {N_TIMED} timed sweeps: {dt:.3f} s = {N_TIMED / dt:.4f} "
          f"sweeps/s; log-likelihood per sweep "
          f"{[round(x, 1) for x in lls]}; edges {int(model.A.sum())}; "
          f"launches {launches}; LAST_SS_PATH {weights.LAST_SS_PATH!r}")
    check(weights.LAST_SS_PATH == "fused",
          f"precision={precision!r} ran the fused loop")
    check(launches[key] == N_TIMED * (n_groups + 1)
          and launches["ss_edge_scan"] == N_TIMED * n_groups
          and launches["pg_devroye"] == N_TIMED,
          f"{key} {n_groups + 1} per sweep, K3 {n_groups}, K1 1")
    others = [k for k in ("ss_group_pass", "ss_group_pass_bf16",
                          "ss_group_pass_sr", "group_gram",
                          "group_gram_bf16") if k != key and launches[k]]
    check(not others, f"no other Gram body launched ({others})")
    check(all(math.isfinite(x) for x in lls)
          and math.isfinite(model.log_likelihood()), "log-likelihoods finite")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    return {f"{precision}_sweeps_per_s": N_TIMED / dt}


def phase_config5_default(check, record, ctx):
    """Config 5 at precision "default" through fit_ensemble (8 stacked
    chains, 1 burn-in + 4 sweeps, collect="mean"): the staged loop on K6's
    bf16 body, no K2."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build

    print(f"config 5 at precision='default': {C5} chains x {N5}", flush=True)
    model = NonlinearAutoregressiveModel(
        N5, B=B, L=L, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, precision="default",
        net_kwargs=dict(dim=2), device="cuda")
    model.add_data(ctx["c5_Y"])
    n_groups = N5 // model.group
    _build.reset_launches()
    t0 = time.perf_counter()
    ens = model.fit_ensemble(n_chains=C5, n_burnin=1, n_samples=4,
                             collect="mean")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n_sw = 5
    print(f"  {n_sw} stacked sweeps in {dt:.3f} s = {n_sw / dt:.4f} stacked "
          f"sweeps/s = {C5 * n_sw / dt:.3f} chain-sweeps/s; launches "
          f"{launches}; lls of the last sweep "
          f"{[round(float(x), 1) for x in ens['lls'][:, -1]]}")
    check(weights.LAST_SS_PATH == "staged", "config 5 ran the staged loop")
    check(launches["group_gram_bf16"] == n_sw and launches["group_gram"] == 0,
          f"K6's bf16 body once per stacked sweep "
          f"({launches['group_gram_bf16']} for {n_sw}), its other bodies 0")
    check(launches["ss_group_pass"] + launches["ss_group_pass_bf16"]
          + launches["ss_group_pass_sr"] == 0, "K2 not launched")
    check(launches["ss_edge_scan"] == n_sw * n_groups
          and launches["pg_devroye"] == n_sw,
          f"K3 {n_groups} and K1 once per stacked sweep")
    check(np.isfinite(ens["lls"]).all() and np.isfinite(ens["rhat_ll"]),
          "log-likelihoods and rhat_ll finite")
    for name in KERNELS:
        record[name]["launches"] += launches[name]
    return {"c5_default_chain_sweeps_per_s": C5 * n_sw / dt}


# The chain-level protocol of benchmarks/sr_parity.py: N=8, B=4 (GB=32, so
# the fused loop runs), T=1500, 150 + 400 sweeps, posterior edge marginals
# of each mode held against the "high" chain. One chain per mode is too
# noisy (two "high" chains of different seeds differed by 0.29 on the CPU),
# so each mode runs PAR_C lane-stacked chains (fit_ensemble) from seeds of
# its own and their pooled marginals compare. The band is set by the run's
# own control, a second "high" pool on other seeds: PAR_BAND_SCALE times
# the control pair's max edge-marginal difference, floored at
# PAR_BAND_FLOOR and capped at PAR_BAND_CAP, the protocol's fixed
# single-chain band (which alone would pass a mode biased by ~0.2 where the
# pooled control reads ~0.14; the cap keeps a noisy control from widening
# the band past it). Each edge's difference
# must also lie within PAR_Z standard errors of the two pools (from the
# spread of their chains): at the many edges that mix well that resolves a
# bias far below the band. Without a bias the largest of 64 |z| lies
# near 2.5-3; the control pair prints it.
PAR_N, PAR_T, PAR_BURN, PAR_KEEP, PAR_C = 8, 1500, 150, 400, 16
PAR_BAND_SCALE, PAR_BAND_FLOOR, PAR_BAND_CAP = 1.5, 0.10, 0.22
PAR_Z = 5.0
PAR_NET = dict(rho_init=0.35, learn_rho=False, mu_bias=-1.2, sigma_bias=0.4,
               learn_weight_prior=False, sigma_w=0.8)


def phase_chain_parity(check):
    """benchmarks/sr_parity.py's chains on the card through fit_ensemble:
    PAR_C pooled chains per mode ("high", "default", "sr"), each pool from
    seeds of its own, and a second "high" pool as the Monte Carlo control.
    Against the first "high" pool, the max posterior edge-marginal
    difference of "default" and "sr" must lie in the band the control pair
    sets (PAR_BAND_SCALE x its difference, within PAR_BAND_FLOOR ..
    PAR_BAND_CAP), and
    every edge's difference (the control's too) within PAR_Z standard
    errors of the two pools' means. (The f64 NumPy oracle chain of that
    script waits for a copy of the reference sampler in the port.)"""
    import numpy as np
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops.basis import cosine_basis

    print(f"chain parity: N={PAR_N}, T={PAR_T}, {PAR_C} stacked chains per "
          f"mode, {PAR_BURN} + {PAR_KEEP} sweeps", flush=True)
    basis = cosine_basis(B, L)
    Y = SparseBernoulliGLM(PAR_N, basis=basis, seed=123, net_kwargs=PAR_NET,
                           device="cuda").generate(PAR_T, keep=False)
    marg, wmean, paths = {}, {}, {}
    t0 = time.perf_counter()
    for name, prec, s0 in (("high", "high", 1), ("default", "default", 201),
                           ("sr", "sr", 301), ("high_control", "high", 101)):
        m = SparseBernoulliGLM(PAR_N, basis=basis, seed=0,
                               net_kwargs=PAR_NET, precision=prec,
                               device="cuda")
        m.add_data(Y)
        out = m.fit_ensemble(n_chains=PAR_C, n_burnin=PAR_BURN,
                             n_samples=PAR_KEEP,
                             seeds=list(range(s0, s0 + PAR_C)),
                             collect="mean")
        marg[name] = out["A_mean"]                  # (PAR_C, N, N)
        wmean[name] = out["Weff_mean_pooled"]
        paths[name] = weights.LAST_SS_PATH
    dt = time.perf_counter() - t0
    others = ("default", "sr", "high_control")
    ref = marg["high"]
    diff, zmax = {}, {}
    for k in others:
        d = np.abs(marg[k].mean(0) - ref.mean(0))
        # Standard error of the difference from the chains' spread, floored
        # at one kept sweep of one chain (edges that no chain ever flips).
        se = np.sqrt((marg[k].var(0, ddof=1) + ref.var(0, ddof=1)) / PAR_C
                     + (1.0 / (PAR_C * PAR_KEEP)) ** 2)
        diff[k], zmax[k] = float(d.max()), float((d / se).max())
    wdiff = {k: float(np.abs(wmean[k] - wmean["high"]).max()) for k in others}
    print(f"  4 pools in {dt:.1f} s; max edge-marginal diff vs the 'high' "
          f"pool: {diff}; max |z| over the edges: {zmax}; max weight-mean "
          f"diff: {wdiff}; mean edge probability "
          f"{ {k: round(float(v.mean()), 4) for k, v in marg.items()} }; "
          f"loops {paths}")
    check(all(v == "fused" for v in paths.values()),
          "every pool ran the fused loop")
    band = min(PAR_BAND_CAP,
               max(PAR_BAND_FLOOR, PAR_BAND_SCALE * diff["high_control"]))
    check(diff["default"] <= band and diff["sr"] <= band,
          f"default {diff['default']:.3f} and sr {diff['sr']:.3f} within "
          f"{band:.3f} of the 'high' pool ({PAR_BAND_SCALE:g} x the control "
          f"pair's {diff['high_control']:.3f}, within {PAR_BAND_FLOOR:g} .. "
          f"{PAR_BAND_CAP:g})")
    check(all(z < PAR_Z for z in zmax.values()),
          f"every edge within {PAR_Z:g} standard errors of the 'high' pool: "
          f"max |z| default {zmax['default']:.2f}, sr {zmax['sr']:.2f}, "
          f"control {zmax['high_control']:.2f}")
    return {"parity_max_edge_diff": diff, "parity_max_z": zmax,
            "parity_band": band, "parity_s": dt}


def phase_nb_slice(check, record):
    """The NB flagship (benchmarks/common.py) through the user entry points,
    and the launch counts of that run; then one dispersion update without
    the count table, which runs K5."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseNegativeBinomialGLM
    from pyglm_tpu_torch.models import weights
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
    check(launches["pg_devroye"] == 0 and launches["group_gram"] == 0,
          "K1 and K6 not launched by the NB sweep")
    check(weights.LAST_SS_PATH == "fused", "the NB flagship ran the fused loop")
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


def phase_small_parity(check, nb=False, precision="high"):
    """One spike-and-slab update on the card (K2 + K3) and on the CPU
    (plain) from the same state (r included for NB), PG draws and noise,
    at `precision` (at "sr" the same rounding seeds, so both devices round
    Z by the same words). The PG draws come from the card: K1 for
    Bernoulli, K4 for NB."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM, SparseNegativeBinomialGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, pack_weights, resample_spike_slab_tspace)
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    n, t, g = 20, 5000, 4
    print(f"small {'NB' if nb else 'Bernoulli'} slice: card vs CPU, N={n}, "
          f"T={t}, G={g}, precision={precision!r}", flush=True)
    if nb:
        cls, kw = SparseNegativeBinomialGLM, dict(obs_kwargs=NB_OBS)
        truth = cls(n, seed=3, net_kwargs=NB_TRUTH_NET | dict(
            rho_init=0.2, mu_bias=-1.0), device="cpu", **kw)
        Y = np.minimum(truth.generate(t, keep=False), 15.0)
    else:
        cls, kw = SparseBernoulliGLM, {}
        truth = cls(n, seed=3, net_kwargs=TRUTH_NET | dict(
            rho_init=0.2, mu_bias=-1.5), device="cpu")
        Y = truth.generate(t, keep=False)
    mc = cls(n, seed=4, group=g, device="cuda", **kw)
    mh = cls(n, seed=4, group=g, device="cpu", **kw)
    mc.add_data(Y)
    mh.add_data(Y)
    mc.fit(n_samples=3)
    s = state_to_numpy(mc.state)
    mh.state = state_from_numpy(s["A"], s["W"], s["b"], s["net"],
                                device="cpu", aux=s["aux"])
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
                           torch.randn((n,), generator=gen),
                           torch.randint(0, 2 ** 62, (ng, 2), generator=gen))
    noise_c = noise._replace(u_a=noise.u_a.cuda(), eps=noise.eps.cuda(),
                             bias=noise.bias.cuda())
    out_c = resample_spike_slab_tspace(
        None, mc.datas[0].Xt, omega_c, kappa_c, psi_c, w_c,
        hyp_c, 4, group=g, noise=noise_c, precision=precision)
    omega_h = omega_c.cpu()
    out_h = resample_spike_slab_tspace(
        None, mh.datas[0].Xt, omega_h, kappa_h, psi_h, w_h,
        hyp_h, 4, group=g, noise=noise, precision=precision)
    check(weights.LAST_SS_PATH == "fused", "small update ran the fused loop")
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
            hyp_h, 4, group=g, noise=noise, precision="high")
        sens_w = rel_err(out_64[1], out_h[1])
        sens_u = float((out_64[2] - out_h[2]).abs().max())
        print(f"  CPU's own sensitivity to rounding psi: w {sens_w:.2e}, "
              f"u {sens_u:.2e}")
        w_tol, u_tol = max(w_tol, 10 * sens_w), max(u_tol, 10 * sens_u)
    check(werr <= w_tol, f"w_full max|diff|/max|w| = {werr:.2e} "
          f"(max|w| = {float(out_h[1].abs().max()):.3f}; limit {w_tol:.2e})")
    check(uerr <= u_tol, f"u max|diff| = {uerr:.2e} (limit {u_tol:.2e})")


def phase_kernel_gram(check, record):
    """K6 against its plain version at the 8-chain config-5 ensemble's
    shapes, each body ("high" 3xTF32, "highest" fp32 FMA, "default" bf16)
    also against a float64 Gram of its operands, and at a small ragged
    shape."""
    import torch
    from pyglm_tpu_torch.ops.basis import design_matrix, cosine_basis
    from pyglm_tpu_torch.ops.gram_cuda import (
        PAIR_TILE, group_gram_blocks_cuda, group_gram_blocks_plain,
        wgmma_probe)
    from pyglm_tpu_torch.ops.ss_cuda import pair_index, to_bf16

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5150)
    # The "default" body's wgmma layouts on known tiles (small integers, so
    # every sum is exact).
    a16 = torch.randint(-3, 4, (64, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    b16 = torch.randint(-3, 4, (PAIR_TILE, 64), generator=gen,
                        device=dev).to(torch.bfloat16)
    check(torch.equal(wgmma_probe(a16, b16), a16.float().T @ b16.float().T),
          "wgmma probe (m64n168k16, A lane-major, B K-major, 128-byte "
          "swizzle) equals torch.mm")
    lanes, GB = C5 * N5, G5 * B
    Ng, npair = N5 // G5, GB * (GB + 1) // 2
    print(f"K6 group_gram: Xt ({N5 * B + 1}, {T5}), omega ({T5}, {lanes}), "
          f"G={G5}, B={B}", flush=True)
    Y = (torch.rand((T5, N5), generator=gen, device=dev) < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(B, L)).T.contiguous()
    del Y
    omega = 0.05 + 0.2 * torch.rand((T5, lanes), generator=gen, device=dev)
    p_idx, q_idx = pair_index(GB, dev)
    f64, f64_plain, max_abs = {}, {}, {}
    for prec in ("high", "highest", "default"):
        p = group_gram_blocks_plain(Xt, omega, B, G5, precision=prec)
        k = group_gram_blocks_cuda(Xt, omega, B, G5, precision=prec)
        if prec == "high":
            jg_high = k                     # K3's input below
        torch.cuda.synchronize()
        err = rel_err(k, p)
        tol = REL_TOL if prec == "default" else GRAM_REL_TOL
        check(err <= tol, f"K6 {prec} at config 5: max|diff|/"
              f"max|plain| = {err:.2e} (limit {tol:.0e})")
        check(torch.equal(k, group_gram_blocks_cuda(Xt, omega, B, G5,
                                                    precision=prec)),
              f"K6 {prec} repeats bit for bit")
        max_abs[prec] = float((k - p).abs().max())
        # Groups 0 and Ng - 1 against a float64 Gram of the body's operands.
        om64 = (to_bf16(omega) if prec == "default" else omega).double()
        for g in (0, Ng - 1):
            xg = Xt[g * GB:(g + 1) * GB]
            Z = xg[p_idx] * xg[q_idx]
            j64 = (to_bf16(Z) if prec == "default" else Z).double() @ om64
            f64[prec] = max(f64.get(prec, 0.0), rel_err(k[g].double(), j64))
            f64_plain[prec] = max(f64_plain.get(prec, 0.0),
                                  rel_err(p[g].double(), j64))
            del j64, Z
        del k, p, om64
        print(f"  K6 {prec} vs a float64 Gram (groups 0 and {Ng - 1}): "
              f"{f64[prec]:.2e}; its plain version: {f64_plain[prec]:.2e}")
        check(f64[prec] <= F64_RATIO * f64_plain[prec],
              f"K6 {prec} within {F64_RATIO:g}x its plain version's float64 "
              f"error")
    Xs = (torch.rand((6 * B + 1, 3001), generator=gen, device=dev)
          < 0.3).float()
    oms = 0.05 + 0.2 * torch.rand((3001, 70), generator=gen, device=dev)
    for prec in ("high", "highest", "default"):
        e2 = rel_err(group_gram_blocks_cuda(Xs, oms, B, 3, precision=prec),
                     group_gram_blocks_plain(Xs, oms, B, 3, precision=prec))
        check(e2 <= GRAM_REL_TOL,
              f"K6 {prec} at T=3001, GB=12, 70 lanes: {e2:.2e}")
    times = {}
    for prec in ("high", "highest", "default", "default", "highest",
                 "high"):
        times.setdefault(prec, []).append(event_ms(
            lambda: group_gram_blocks_cuda(Xt, omega, B, G5, precision=prec),
            3))
    ms, ms_fp32, ms_bf16 = (min(times[p]) for p in
                            ("high", "highest", "default"))
    plain_ms = event_ms(lambda: group_gram_blocks_plain(Xt, omega, B, G5),
                         3)
    plain_bf16_ms = event_ms(lambda: group_gram_blocks_plain(
        Xt, omega, B, G5, precision="default"), 3)
    Z = Xt[:GB][p_idx] * Xt[:GB][q_idx]
    lib_ms = Ng * event_ms(lambda: torch.matmul(Z, omega), 5)
    lib_bf16_ms, lib_out = bf16_matmul_ms(Z, omega, 5)
    lib_bf16_ms *= Ng
    del Z
    # The design rows and omega in, the packed Gram out; Ng*npair*lanes*T
    # FMAs, as three TF32 products at "high", fp32 FMAs at "highest", one
    # bf16 product at "default".
    nbytes = 4 * (Ng * GB * T5 + T5 * lanes + Ng * npair * lanes)
    flops = 2.0 * Ng * npair * lanes * T5
    fp32 = bound(nbytes, (flops, FP32_FLOPS))
    record["group_gram"].update(
        max_abs_err=max_abs["high"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, precision="high", highest_ms=ms_fp32,
        highest_bound_ms=fp32["bound_ms"], f64_rel_err=f64["high"],
        highest_f64_rel_err=f64["highest"],
        plain_f64_rel_err=f64_plain["high"],
        **bound(nbytes, (3 * flops, TF32_FLOPS)))
    record["group_gram_bf16"].update(
        max_abs_err=max_abs["default"], ms=ms_bf16, plain_ms=plain_bf16_ms,
        library_ms=lib_bf16_ms, library_out=lib_out, precision="default",
        f64_rel_err=f64["default"], plain_f64_rel_err=f64_plain["default"],
        **bound(nbytes, (flops, BF16_FLOPS)))
    rec, rec16 = record["group_gram"], record["group_gram_bf16"]
    print(f"  K6 high {times['high']} ms, highest {times['highest']} ms, "
          f"default {times['default']} ms (order high, highest, default, "
          f"default, highest, high); plain {plain_ms:.2f} ms (fp32), "
          f"{plain_bf16_ms:.2f} ms (bf16); library (fp32 matmul on the "
          f"materialised Z, x {Ng} groups) {lib_ms:.2f} ms, (bf16 cuBLAS, "
          f"{lib_out} output) {lib_bf16_ms:.2f} ms; bound "
          f"{rec['bound_ms']:.2f} ms ({rec['bound_by']}, 3xTF32), "
          f"{fp32['bound_ms']:.2f} ms (fp32), {rec16['bound_ms']:.2f} ms "
          f"({rec16['bound_by']}, bf16); {flops / ms / 1e9:.1f} TFLOP/s of "
          f"fp32 work at high, {flops / ms_fp32 / 1e9:.1f} at highest, "
          f"{flops / ms_bf16 / 1e9:.1f} at default")
    phase_k3_config5(check, record, Xt, omega, jg_high, gen)


def phase_k3_config5(check, record, Xt, omega, Jg, gen):
    """K3 at config 5's shape (G=10, B=4, 4000 lanes) on the "high" Gram of
    every group, one call per group in the staged loop's order, so that each
    group's 13 MB Gram slice comes from device memory as in a sweep; priors
    with a non-identity Lam0 and a nonzero mu0. Against its plain version on
    the same noise (A identical, W and dW within W_ATOL), timed over whole
    passes of the 50 groups."""
    import torch
    from pyglm_tpu_torch.diagnostics.timing import edge_scan_priors
    from pyglm_tpu_torch.ops.ss_cuda import (
        edge_scan_plan, ss_edge_scan_cuda, ss_edge_scan_plain)

    dev = "cuda"
    lanes, GB = C5 * N5, G5 * B
    Ng, npair = N5 // G5, GB * (GB + 1) // 2
    print(f"K3 ss_edge_scan at config 5: {Ng} groups of G={G5} edges x "
          f"{lanes} lanes, B={B}, lane tile {edge_scan_plan(G5, B, lanes)}",
          flush=True)
    u = 0.5 * torch.randn((T5, lanes), generator=gen, device=dev)
    M0 = Xt[:Ng * GB] @ u
    del u
    mu, lam, lrho, u_a, eps = edge_scan_priors(gen, N5, lanes, B, dev)
    w0 = (torch.randn((Ng * GB, lanes), generator=gen, device=dev)
          * (torch.rand((Ng * GB, lanes), generator=gen, device=dev) < 0.25))

    def sweep(scan, w):
        """One call per group, in order; [(dW, A)] of every group."""
        return [scan(Jg[g], M0[g * GB:(g + 1) * GB], w[g * GB:(g + 1) * GB],
                     mu[g * G5:(g + 1) * G5], lam[g * G5:(g + 1) * G5],
                     lrho[g * G5:(g + 1) * G5], u_a[g * G5:(g + 1) * G5],
                     eps[g * G5:(g + 1) * G5]) for g in range(Ng)]

    w_k, w_p = w0.clone(), w0.clone()
    dW_k, a_k = (torch.cat(t) for t in zip(*sweep(ss_edge_scan_cuda, w_k)))
    dW_p, a_p = (torch.cat(t) for t in zip(*sweep(ss_edge_scan_plain, w_p)))
    torch.cuda.synchronize()
    n_diff = int((a_k != a_p).sum())
    check(n_diff == 0, f"K3 at config 5: A identical ({n_diff} of "
          f"{a_k.numel()} differ; {int(a_k.sum())} active)")
    check(0 < int(a_k.sum()) < a_k.numel(), "K3 at config 5: both a = 0 "
          "and a = 1 occur")
    werr = float((w_k - w_p).abs().max())
    derr = float((dW_k - dW_p).abs().max())
    check(werr <= W_ATOL and derr <= W_ATOL,
          f"K3 at config 5: W max|diff| = {werr:.2e}, dW max|diff| = "
          f"{derr:.2e}")
    del dW_k, dW_p, w_p
    # Device time by the profiler: a call's host work (~tens of us) exceeds
    # the kernel's, so CUDA events around back-to-back calls would time the
    # host; in a sweep the host runs ahead while K2 or K6 runs.
    ms = kernel_ms(lambda: sweep(ss_edge_scan_cuda, w_k), 3,
                   "edge_scan_kernel") / Ng
    ev_ms = event_ms(lambda: sweep(ss_edge_scan_cuda, w_k), 3) / Ng
    plain_ms = event_ms(lambda: ss_edge_scan_plain(
        Jg[0], M0[:GB], w0[:GB].clone(), mu[:G5], lam[:G5], lrho[:G5],
        u_a[:G5], eps[:G5]), 2)
    b = k3_bound(G5, B, lanes)
    record["ss_edge_scan"].update(
        config5_ms=ms, config5_plain_ms=plain_ms,
        config5_bound_ms=b["bound_ms"], config5_bound_by=b["bound_by"],
        config5_max_abs_err=max(werr, derr), config5_event_ms=ev_ms)
    print(f"  K3 at config 5: {ms:.4f} ms per group on the device (cold, "
          f"{Ng} groups in order; {ev_ms:.4f} ms per call back to back, "
          f"host included), plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")


def phase_kernel_gram_flagship(check, record):
    """K6's fp32 body ("highest") at the flagship's main-path shape, the
    staged loop's call at precision "highest": Xt (801, 100000), omega
    (100000, 200), G = 8, B = 4 (25 groups of 32 rows). Against its plain
    version, a float64 Gram of groups 0 and 24, itself, cuBLAS SGEMM on the
    materialised Z (the library call) and its bound."""
    import torch
    from pyglm_tpu_torch.ops.basis import design_matrix, cosine_basis
    from pyglm_tpu_torch.ops.gram_cuda import (
        fp32_split_plan, group_gram_blocks_cuda, group_gram_blocks_plain)
    from pyglm_tpu_torch.ops.ss_cuda import pair_index

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8080)
    GB = G * B
    Ng, npair = N // G, GB * (GB + 1) // 2
    print(f"K6 group_gram at 'highest', the flagship's shape: Xt "
          f"({N * B + 1}, {T}), omega ({T}, {N}), G={G}, B={B}; plan "
          f"(splits, steps) {fp32_split_plan(GB, N, T, Ng)}",
          flush=True)
    Y = (torch.rand((T, N), generator=gen, device=dev) < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(B, L)).T.contiguous()
    del Y
    omega = 0.05 + 0.2 * torch.rand((T, N), generator=gen, device=dev)

    def gram():
        return group_gram_blocks_cuda(Xt, omega, B, G, precision="highest")

    k = gram()
    plain = group_gram_blocks_plain(Xt, omega, B, G, precision="highest")
    torch.cuda.synchronize()
    err = rel_err(k, plain)
    check(err <= GRAM_REL_TOL, f"K6 highest at the flagship: max|diff|/"
          f"max|plain| = {err:.2e} (limit {GRAM_REL_TOL:.0e})")
    check(torch.equal(k, gram()), "K6 highest at the flagship repeats bit "
          "for bit")
    p_idx, q_idx = pair_index(GB, dev)
    f64 = f64_plain = 0.0
    for g in (0, Ng - 1):
        xg = Xt[g * GB:(g + 1) * GB]
        j64 = (xg[p_idx] * xg[q_idx]).double() @ omega.double()
        f64 = max(f64, rel_err(k[g].double(), j64))
        f64_plain = max(f64_plain, rel_err(plain[g].double(), j64))
        del j64
    max_abs = float((k - plain).abs().max())
    del k, plain
    check(f64 <= F64_RATIO * f64_plain,
          f"K6 highest at the flagship vs a float64 Gram (groups 0 and "
          f"{Ng - 1}): {f64:.2e}, within {F64_RATIO:g}x its plain "
          f"version's {f64_plain:.2e}")
    ms = min(event_ms(gram, 5) for _ in range(2))
    plain_ms = event_ms(lambda: group_gram_blocks_plain(
        Xt, omega, B, G, precision="highest"), 3)
    Z = Xt[:GB][p_idx] * Xt[:GB][q_idx]
    lib_ms = Ng * event_ms(lambda: torch.matmul(Z, omega), 5)
    del Z
    nbytes = 4 * (Ng * GB * T + T * N + Ng * npair * N)
    flops = 2.0 * Ng * npair * N * T
    b = bound(nbytes, (flops, FP32_FLOPS))
    record["group_gram"].update(
        highest_flagship_ms=ms, highest_flagship_plain_ms=plain_ms,
        highest_flagship_library_ms=lib_ms,
        highest_flagship_bound_ms=b["bound_ms"],
        highest_flagship_max_abs_err=max_abs,
        highest_flagship_f64_rel_err=f64,
        highest_flagship_plain_f64_rel_err=f64_plain)
    print(f"  K6 highest at the flagship {ms:.3f} ms ({flops / ms / 1e9:.1f}"
          f" TFLOP/s), plain {plain_ms:.3f} ms, cuBLAS SGEMM on the "
          f"materialised Z x {Ng} groups {lib_ms:.3f} ms, bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']})")


def phase_config5(check, record, ctx):
    """Acceptance config 5 through the user entry points: a latent-distance
    truth model (N=500) generates T=20k bins; the fitted model runs
    fit_ensemble with 8 lane-stacked chains, first a short
    collect="samples" run, then the timed collect="mean" run."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.utils.metrics import link_auc

    kw = dict(B=B, L=L, observation="bernoulli", network="latent_distance",
              spike_and_slab=True, device="cuda")
    print(f"config 5: latent-distance truth N={N5}, generate T={T5}",
          flush=True)
    truth = NonlinearAutoregressiveModel(N5, seed=5, net_kwargs=C5_TRUTH_NET,
                                         **kw)
    t0 = time.perf_counter()
    Y = truth.generate(T5, keep=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    print(f"  generate: {gen_s:.2f} s, rate {Y.mean():.4f} spikes/bin, "
          f"{int(truth.A.sum())} true edges")
    ctx["c5_Y"] = Y
    model = NonlinearAutoregressiveModel(N5, seed=0, precision="high",
                                         net_kwargs=dict(dim=2), **kw)
    t0 = time.perf_counter()
    model.add_data(Y)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    print(f"  add_data: {add_s:.3f} s")
    n_groups = N5 // model.group

    def run(n_burnin, n_samples, collect):
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model.fit_ensemble(n_chains=C5, n_burnin=n_burnin,
                                 n_samples=n_samples, collect=collect)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        n_sw = n_burnin + n_samples
        print(f"  fit_ensemble(collect={collect!r}): {n_sw} stacked sweeps "
              f"in {dt:.3f} s; launches {launches}")
        check(weights.LAST_SS_PATH == "staged",
              f"config 5 ran the staged loop ({weights.LAST_SS_PATH})")
        check(launches["group_gram"] == n_sw,
              f"K6 launched once per stacked sweep ({launches['group_gram']}"
              f" for {n_sw})")
        check(launches["ss_group_pass"] == 0, "K2 not launched")
        check(launches["pg_devroye"] == n_sw,
              f"K1 launched once per stacked sweep ({launches['pg_devroye']})")
        check(launches["ss_edge_scan"] == n_sw * n_groups,
              f"K3 launched {n_groups} times per stacked sweep")
        for name in KERNELS:
            record[name]["launches"] += launches[name]
        return out, n_sw, dt

    samp, _, _ = run(0, 4, "samples")
    check(samp["lls"].shape == (C5, 4) and np.isfinite(samp["lls"]).all(),
          "samples: (C, S) log-likelihoods finite")
    check(samp["rhat_edge"].shape == (N5, N5) and np.isfinite(
        samp["rhat_ll"]), f"samples: rhat_ll = {samp['rhat_ll']:.3f}")
    del samp
    ens, n_sw, dt = run(1, 4, "mean")
    lls = ens["lls"]
    acc = [float(s.net.hmc_accept) for s in ens["final_states"]]
    auc = link_auc(ens["A_mean_pooled"], truth.A)
    print(f"  {n_sw / dt:.4f} stacked sweeps/s = {C5 * n_sw / dt:.3f} "
          f"chain-sweeps/s (precision='high', {C5} chains x {N5} lanes)")
    print(f"  log-likelihood per chain, last sweep: "
          f"{[round(float(x), 1) for x in lls[:, -1]]}; hmc_accept "
          f"{[round(a, 2) for a in acc]}; rhat_ll {ens['rhat_ll']:.3f}; "
          f"pooled link AUC {auc:.4f}")
    check(lls.shape == (C5, 4) and np.isfinite(lls).all(),
          "mean: (C, S) log-likelihoods finite")
    check(all(0.0 <= a <= 1.0 for a in acc), "0 <= hmc_accept <= 1")
    check(np.isfinite(ens["rhat_ll"]), "mean: rhat_ll finite")
    check(ens["A_mean_pooled"].shape == (N5, N5)
          and np.isfinite(ens["Weff_mean_pooled"]).all(),
          "pooled means finite, shapes right")
    ctx.update(model=model, states=ens["final_states"])
    return {"c5_stacked_sweeps_per_s": n_sw / dt,
            "c5_chain_sweeps_per_s": C5 * n_sw / dt,
            "c5_generate_s": gen_s, "c5_add_data_s": add_s}


def phase_staged_vs_fused(check, ctx):
    """One spike-and-slab update at the ensemble's width (4000 lanes) by
    the staged loop (K6 + K3) and by the fused loop (K2 + K3), from the
    same state, PG draws and noise."""
    import torch
    from pyglm_tpu_torch.models.ensemble import lane_inputs
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, resample_spike_slab_tspace)
    from pyglm_tpu_torch.ops.gram_cuda import group_gram_blocks_plain

    model, states = ctx["model"], ctx["states"]
    d = model.datas[0]
    w, hyp = lane_inputs(model.network, states)
    lanes, G = w.shape[1], model.group
    print(f"staged vs fused loop: one update at {lanes} lanes, G={G}, "
          f"precision='high' (3xTF32 in both)", flush=True)
    psi = d.Xf @ w
    omega, kappa = model.observation.omega_kappa(
        model.generators.host, d.Y.repeat(1, len(states)), psi, None)
    gen = torch.Generator(device="cuda").manual_seed(77)
    ng = N5 // G
    noise = SpikeSlabNoise(
        torch.rand((ng, G, lanes), generator=gen, device="cuda"),
        torch.randn((ng, G, lanes, B), generator=gen, device="cuda"),
        torch.randn((lanes,), generator=gen, device="cuda"))

    def update(path):
        return resample_spike_slab_tspace(None, d.Xt, omega, kappa, psi, w,
                                          hyp, B, group=G, noise=noise,
                                          path=path, precision="high")
    out = {path: update(path) for path in ("staged", "fused")}
    ms = {}
    for path in ("staged", "fused", "fused", "staged"):
        ms.setdefault(path, []).append(event_ms(lambda: update(path), 2))
    # The update's own sensitivity to float32 rounding: the fused loop with
    # psi rounded from a float64 product instead of the float32 GEMM, and
    # the staged loop on the plain version's Gram (cuBLAS, another
    # summation order over T) instead of K6's.
    psi64 = (d.Xf.double() @ w.double()).float()
    A_r, w_r = resample_spike_slab_tspace(
        None, d.Xt, omega, kappa, psi64, w, hyp, B, group=G, noise=noise,
        path="fused", precision="high")[:2]
    del psi64
    A_p, w_p = resample_spike_slab_tspace(
        None, d.Xt, omega, kappa, psi, w, hyp, B, group=G, noise=noise,
        Jg=group_gram_blocks_plain(d.Xt, omega, B, G))[:2]

    def compare(A1, w1, A2, w2):
        diff = A1 != A2
        same = ~diff.any(0)               # lanes whose edges all agree
        return (int(diff.sum()),
                float((w1 - w2)[:, same].abs().max() / w2.abs().max()))
    (A_s, w_s, _, _), (A_f, w_f, _, _) = out["staged"], out["fused"]
    n_diff, werr = compare(A_s, w_s, A_f, w_f)
    n_psi, w_psi = compare(A_r, w_r, A_f, w_f)
    n_gram, w_gram = compare(A_s, w_s, A_p, w_p)
    n_self, w_self = max(n_psi, n_gram), max(w_psi, w_gram)
    n_lim, w_lim = max(5, 10 * n_self), max(1e-4, 10 * w_self)
    print(f"  staged {ms['staged']} ms, fused {ms['fused']} ms per update "
          f"(order staged, fused, fused, staged); {int(A_s.sum())} of "
          f"{A_s.numel()} edges active")
    print(f"  staged vs fused: {n_diff} edges differ, w {werr:.2e} of "
          f"max|w| on the agreeing lanes; fused with psi rounded from "
          f"float64: {n_psi} edges, w {w_psi:.2e}; staged on the plain "
          f"Gram: {n_gram} edges, w {w_gram:.2e}")
    check(n_diff <= n_lim, f"A agrees but for {n_diff} edges (limit "
          f"{n_lim}: 5, or 10x the fused loop's own rounding sensitivity)")
    check(werr <= w_lim, f"w on the agreeing lanes: {werr:.2e} (limit "
          f"{w_lim:.2e}: 1e-4, or 10x the own sensitivity)")
    return {"staged_update_ms": min(ms["staged"]),
            "fused_update_ms": min(ms["fused"])}


def phase_small_staged_parity(check):
    """One staged spike-and-slab update of 2 lane-stacked chains (N=20,
    T=300 < 384 routes it staged) on the card (K6 + K3) and on the CPU
    (plain), from the same states, PG draws and noise."""
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.ensemble import chain_generators, lane_inputs
    from pyglm_tpu_torch.models.sweep import init_state_from_prior
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    n, t, C = 20, 300, 2
    print(f"small staged update: card vs CPU, N={n}, T={t}, {C} chains",
          flush=True)
    truth = SparseBernoulliGLM(n, seed=3, net_kwargs=TRUTH_NET | dict(
        rho_init=0.2, mu_bias=-1.5), device="cpu")
    Y = truth.generate(t, keep=False)
    mc = SparseBernoulliGLM(n, seed=4, device="cuda")
    mh = SparseBernoulliGLM(n, seed=4, device="cpu")
    mc.add_data(Y)
    mh.add_data(Y)
    states_h = [init_state_from_prior(chain_generators(sd, "cpu"),
                                      mh.observation, mh.network, n, B, True,
                                      "cpu") for sd in (1, 2)]
    states_c = []
    for st in states_h:
        x = state_to_numpy(st)
        states_c.append(state_from_numpy(x["A"], x["W"], x["b"], x["net"]))
    w_c, hyp_c = lane_inputs(mc.network, states_c)
    w_h, hyp_h = lane_inputs(mh.network, states_h)
    psi_c = mc.datas[0].Xf @ w_c
    omega_c, kappa_c = mc.observation.omega_kappa(
        mc.generators.host, mc.datas[0].Y.repeat(1, C), psi_c, None)
    psi_h = mh.datas[0].Xf @ w_h
    kappa_h = mh.datas[0].Y.repeat(1, C) - 0.5
    g, lanes = mh.group, C * n
    gen = torch.Generator().manual_seed(6)
    noise = weights.SpikeSlabNoise(
        torch.rand((n // g, g, lanes), generator=gen),
        torch.randn((n // g, g, lanes, B), generator=gen),
        torch.randn((lanes,), generator=gen))
    out_h = weights.resample_spike_slab_tspace(
        None, mh.datas[0].Xt, omega_c.cpu(), kappa_h, psi_h, w_h, hyp_h, B,
        noise=noise)
    noise_c = weights.SpikeSlabNoise(*(x.cuda() for x in noise[:3]))
    for prec in ("highest", "high"):          # K6's fp32 and 3xTF32 bodies
        _build.reset_launches()
        out_c = weights.resample_spike_slab_tspace(
            None, mc.datas[0].Xt, omega_c, kappa_c, psi_c, w_c, hyp_c, B,
            noise=noise_c, precision=prec)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(weights.LAST_SS_PATH == "staged"
              and launches["group_gram"] == 1
              and launches["ss_group_pass"] == 0,
              f"{prec}: card update ran the staged loop (K6 once, K2 never; "
              f"{launches})")
        n_diff = int((out_c[0].cpu() != out_h[0]).sum())
        check(n_diff == 0, f"{prec}: A identical ({n_diff} of {n * lanes} "
              f"differ; {int(out_h[0].sum())} active)")
        werr = rel_err(out_c[1].cpu(), out_h[1])
        uerr = float((out_c[2].cpu() - out_h[2]).abs().max())
        check(werr <= REL_TOL, f"{prec}: w_full max|diff|/max|w| = "
              f"{werr:.2e} (limit {REL_TOL:.0e})")
        check(uerr <= 1e-3, f"{prec}: u max|diff| = {uerr:.2e} (limit 1e-3)")


def phase_hmc_parity(check):
    """One latent-distance resample of 2 chains at N=50 on the card and on
    the CPU with the same injected noise (HMC, swaps, relocations)."""
    import torch
    from pyglm_tpu_torch.models.networks import (
        HMCNoise, LatentDistanceConfig, LatentDistanceState)
    from pyglm_tpu_torch.models.sweep import Generators

    C, n = 2, 50
    print(f"latent-distance HMC: card vs CPU, N={n}, {C} chains", flush=True)
    cfg = LatentDistanceConfig(N=n, B=B, hmc_eps=0.03, swap_moves=10,
                               relocate_moves=10)
    g = torch.Generator().manual_seed(8)
    Lp = 0.8 * torch.randn((C, n, 2), generator=g)
    gamma = torch.tensor([0.3, -0.2])
    A = (torch.rand((C, n, n), generator=g)
         < torch.sigmoid(cfg._logit_rho(Lp, gamma))).float()
    W = torch.randn((C, n, n, B), generator=g) * A[..., None]
    noise = cfg.draw_noise(g, C, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        st = LatentDistanceState(Lp.to(dev), gamma.to(dev), torch.zeros(C, B),
                                 torch.eye(B).repeat(C, 1, 1),
                                 torch.zeros(C, device=dev))
        gens = Generators(torch.Generator(device=dev),
                          torch.Generator().manual_seed(1))
        outs[dev] = cfg.resample(gens, st, A.to(dev), W.to(dev),
                                 noise=HMCNoise(*(x.to(dev) for x in noise)))
    h, c = outs["cpu"], outs["cuda"]
    lerr = float((h.L - c.L.cpu()).abs().max())
    gerr = float((h.gamma - c.gamma.cpu()).abs().max())
    print(f"  hmc_accept CPU {h.hmc_accept.tolist()}, card "
          f"{c.hmc_accept.tolist()}")
    # Compare counts: the card divides by a scalar through its reciprocal.
    same = torch.equal((h.hmc_accept * cfg.hmc_iters).round(),
                       (c.hmc_accept.cpu() * cfg.hmc_iters).round())
    check(same, "same accepts")
    check(lerr <= 1e-4 and gerr <= 1e-4,
          f"L max|diff| = {lerr:.2e}, gamma {gerr:.2e} (limit 1e-4)")


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
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()

    check = Checks()
    record = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0,
                     **{k: None for k in RECORD_KEYS[1:]}}
              for name, (src, rep) in KERNELS.items()}
    summary, ctx = {}, {}
    for phase in (lambda: phase_kernels(check, record),
                  lambda: phase_kernels_nb(check, record),
                  lambda: phase_kernel_gram(check, record),
                  lambda: phase_kernel_gram_flagship(check, record),
                  lambda: summary.update(phase_slice(check, record, ctx)),
                  lambda: summary.update(phase_highest(check, record, ctx)),
                  lambda: summary.update(phase_bf16_flagship(
                      check, record, ctx, "default")),
                  lambda: summary.update(phase_bf16_flagship(
                      check, record, ctx, "sr")),
                  lambda: summary.update(phase_nb_slice(check, record)),
                  lambda: summary.update(phase_config5(check, record, ctx)),
                  lambda: summary.update(phase_config5_default(
                      check, record, ctx)),
                  lambda: summary.update(phase_staged_vs_fused(check, ctx)),
                  lambda: phase_small_parity(check),
                  lambda: phase_small_parity(check, nb=True),
                  lambda: phase_small_parity(check, precision="default"),
                  lambda: phase_small_parity(check, precision="sr"),
                  lambda: phase_small_staged_parity(check),
                  lambda: phase_hmc_parity(check),
                  lambda: summary.update(phase_chain_parity(check))):
        try:
            phase()
        except Exception:                      # recorded; the run fails
            traceback.print_exc()
            check(False, "phase raised")
        torch.cuda.empty_cache()
    check("jax" not in sys.modules, "JAX was not imported")
    for name, rec in record.items():
        missing = [k for k in RECORD_KEYS
                   if rec[k] is None and k != "library_ms"]
        check(not missing and rec["launches"] > 0,
              f"{name}: record complete, launched on a main path "
              f"({rec['launches']}){f'; missing {missing}' if missing else ''}")
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
