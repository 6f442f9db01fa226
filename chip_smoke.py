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
     (N=200, T=100k, B=4, G=8) K1-K3 (K2's Gram in 3xTF32 on wgmma, timed
     at g = 0 and at a middle group, the Gram kernel and the streaming
     pass (the scatter and M0 in fp32, one pass over u) alone also timed
     by torch.profiler, beside the library sequence of the pass and with
     M0 held against a float64 M0; then in one bf16 pass
     ("default") and on a stochastically rounded Z ("sr", on the same
     rounding words as its plain version), both on wgmma over the bf16
     omega stream, the only omega K2 reads there (its scatter and sum_t
     omega bit for bit those of "high" on the float32 rounded omega), the
     Gram kernel alone also timed by torch.profiler),
     K2's SR Gram at a small shape
     (unbiased over 256 seeds), then the NB kernels K4 (gamma-series PG;
     its bound from a count of the special-function operations its
     proposals need at the SFU's rate) and K5 (CRT counts, per element and
     summed per column: the law, both forms equal to the numpy twin's
     draws bit for bit, device time by torch.profiler at the NB counts and
     at a high-count shape); at the 8-chain
     latent-distance ensemble's shapes (P=2001, T=20k, 4000 lanes, G=10)
     K6 (group Gram) at precision "high" (3xTF32 on wgmma), "highest"
     (fp32 FMA) and "default" (one bf16 pass on wgmma over a bf16 omega
     stream), after the two wgmma layout probes (bf16 and TF32), plus
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
     table, which runs K5's sums form; then the acceptance suite's config 5
     (latent-distance prior, N=500, T=20k) through fit_ensemble with 8
     lane-stacked chains, a short collect="samples" run and a timed
     collect="mean" run on the staged loop (K6 + K3), and 5 stacked sweeps
     at precision="default" (K6's bf16 wgmma body). Then: the staged and
     the fused loop on one update at the ensemble's width with the same
     noise; small models on the card held against the same models on the
     CPU (Bernoulli at "high", "default" and "sr" and NB on the fused
     loop, 2 stacked chains on the staged loop at "high" and "highest"):
     same state, same PG draws and noise, same result; the
     latent-distance HMC on the card against the CPU with the same noise.
     Acceptance
     config 1 (BernoulliGLM, N=27, T=60k: K1 and the fp32 dense update)
     with its dense update on the card against the CPU on the same noise,
     its stacked ensemble (8 chains) and NegativeBinomialGLM (K4; K5 when
     stacked) and BinomialGLM (K4) at its shape; config 4 (the SBM prior,
     K=5, N=100, T=40k) at "high", "default" and "sr" on the fused loop,
     the SBM resample and its label scan timed apart; SparseGaussianGLM
     at the flagship's shapes (its cached group Gram by K6 against K6's
     plain version, sweeps on the staged loop reading that Gram, one
     update on it against the staged loop forming the Gram) and
     GaussianGLM at config 1's shape; every class of the model surface
     (the default model, BernoulliGLM, GaussianGLM, SparseGaussianGLM,
     NegativeBinomialGLM, BinomialGLM, the SBM) through fit and
     fit_ensemble at N=12. Then, after the acceptance runs: parallel
     tempering of config 5's model (fit_tempered, 8 rungs x 500 lanes,
     T=20k, "high": a 20 + 20-sweep pilot sets the ladder, 10 tempered
     sweeps timed, 2 profiled for the device busy time; K4 once, K6 once
     and K3 50 times a tempered sweep), with K4 at the tempered shape
     (20000, 4000), b the betas tiled, against pg_mean / pg_var per rung
     and its plain version, at the run's ladder and at suggest_ladder's
     floor (beta = 0.05), timed and bounded; the standalone regressions at
     the NB flagship's size (the NB regression of its counts on the
     previous bin's, T = 1e5, D_in = D_out = 200: K4 and K5; the Bernoulli
     regression: K1) and pgdrawv at 2e7 draws (K1; K4); and exact resume
     from a checkpoint at the flagship (two 5-sweep continuations equal).
     K1 and K4 against the port's exact native PG sampler
     (pyglm_tpu_torch/native, built with g++; KS per c and b).
  3. Correctness against references other than the port itself:
     - acceptance (pyglm_tpu_torch/acceptance.py): config 1 (dense,
       N=27), config 2 (NB, N=50), config 3 (N=100) and config 4 (SBM,
       N=100) at full length, configs 3 and 4 at "high", "default" and
       "sr" on one simulated dataset each, gated by
       benchmarks/acceptance.py's floors; a
       config-2 truth whose counts run away past max_y is refused and
       recorded, not scored; config 5 cut to ACC_C5_SWEEPS, ungated but
       for finite, complete fields;
     - the chains of benchmarks/sr_parity.py (N=8, T=1500, 150 + 400
       sweeps; pyglm_tpu_torch/diagnostics/parity.py): a pool of 64
       lane-stacked chains at each of "high", "default" and "sr" and a
       second "high" pool, the control, each held to the first "high" pool
       within a band from random splits of the two pools' chains (at most
       0.22) and a per-edge |z| < 5; then every pool held to 32 chains of
       the f64 NumPy oracle (the port's copy, in spawned processes with one
       BLAS thread each) at tests/test_numpy_parity.py's tolerances and a
       per-edge |z| < 5; pools of lane-stacked chains of the
       dense-NIW, Gaussian and SBM oracle configs of
       tests/test_numpy_parity.py against 8 oracle chains each, at those
       tests' tolerances and a per-edge |z| < 5; and the cold rungs of 64
       tempering ladders (diagnostics/parity.py::tempered_pool: 256 rungs
       as one tempered pass, the swaps drawn per ladder) held to the same
       32 oracle chains at the same gates;
     - Geweke (tests/test_geweke_tpu.py's protocol: N=8, T=384, 4000
       iterations, 500 burn-in, n_eff by the autocorrelation time):
       Bernoulli at "high" and "sr", NB with the count table, Binomial,
       and at 3000 iterations (tests/test_geweke.py's) the dense Gaussian,
       the SBM (at that file's shape, N=3, B=1, T=50: the staged loop)
       and the sparse Gaussian, one spawned process per lane, read at the
       end;
       each spike-and-slab lane must run the fused loop and its
       kernels.
     Every timed phase runs first, with nothing else on the card or the
     host; the oracle's chains start after the last of them (acceptance),
     the Geweke lanes after the chain parity, beside the config parity.
     Each phase's wall seconds and the run's total are printed.

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
# The native oracle phase: K1 at each c, K4 at each (whole b, c), draws each.
ORACLE_C1 = (0.0, 0.5, 2.0, 10.0)
ORACLE_BC4 = ((2, 0.0), (5, 2.0), (17, 10.0))
ORACLE_DRAWS = 100_000
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
# The regressions phase: resamples of the NB regression; the checkpoint
# phase: sweeps after the save.
REG_RESAMPLES, CK_SWEEPS = 3, 5
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
    # K5's sums form, its own record (LAUNCHES key): the NB r updates.
    "crt_sample_sums": ("pyglm_tpu_torch/csrc/crt.cu",
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
# K2's streaming pass at GB = 32 in its middle-group mode (scatter and
# gather), as nvcc's log names it, omega f(loat) or t (uint16_t, bf16).
STREAM_MIDDLE = "stream_pass_kernelILi32E{}Lb1ELb1E"
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


def kernel_regs(match):
    """{"registers", "spill_bytes"} a thread of the kernel whose (mangled)
    name holds `match`, from the build's ptxas report (nvcc -Xptxas -v),
    or None if no such kernel was compiled."""
    import re
    from pyglm_tpu_torch.ops import _build
    lines = _build.LOG_PATH.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and match in line:
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_bytes": int(spill.group(1)) if spill else None}
    return None


def kernel_ms(fn, reps, match):
    """Device time per call of the kernels whose names hold `match`, over
    `reps` calls traced by torch.profiler (after one untraced call)."""
    from pyglm_tpu_torch.diagnostics.timing import device_ms
    return sum(t for k, t in device_ms(fn, reps).items() if match in k)


def call_kernels(fn, reps):
    """{kernel name: device ms per call} of `fn` by torch.profiler (as
    kernel_ms), and the kernels' short names, sorted."""
    import re
    from pyglm_tpu_torch.diagnostics.timing import device_ms
    ks = device_ms(fn, reps)
    names = sorted({m.group(1) for k in ks
                    for m in [re.search(r"(\w+)(?:<[^()]*>)?\(", k)] if m})
    return ks, names


def stream_lib_ms(xp, xg, om, u, dw, reps):
    """The library sequence of K2's streaming pass on a copy of u: the
    scatter xp.T @ dw and u.addcmul_, then M0 = xg @ u, fp32 GEMMs (TF32
    off)."""
    u_l = u.clone()
    return event_ms(
        lambda: xg @ u_l.addcmul_(om, xp.T @ dw, value=-1.0), reps)


def m0_f64_errors(xg, u_new, m0):
    """(K2's M0, the plain version's xg @ u_new in fp32): each one's
    max |diff| / max |ref| from the float64 M0 of the same u_new."""
    m64 = xg.double() @ u_new.double()
    return (rel_err(m0.double(), m64),
            rel_err((xg @ u_new).double(), m64))


def stream_fields(prec, s_ms, s_bound, s_lib, s_regs, m0_f64, kernels):
    """The fields of K2's record at `prec` for its streaming pass: device
    time, bound, the library sequence's time, registers and spills, M0's
    float64 distance beside the plain version's, and the kernels a call
    launches (short names)."""
    return dict(
        stream_kernel="stream_pass_kernel", stream_ms=s_ms[prec],
        stream_bound_ms=s_bound[prec]["bound_ms"],
        stream_bound_by=s_bound[prec]["bound_by"],
        stream_library_ms=s_lib[prec],
        stream_registers=s_regs[prec].get("registers"),
        stream_spill_bytes=s_regs[prec].get("spill_bytes"),
        m0_f64_rel_err=m0_f64[prec][0],
        m0_plain_f64_rel_err=m0_f64[prec][1], device_kernels=kernels)


def print_stream(prec, rec):
    print(f"  K2 {prec}: the streaming pass alone {rec['stream_ms']:.4f} ms "
          f"(profiler; bound {rec['stream_bound_ms']:.4f} ms, "
          f"{rec['stream_bound_by']}; {rec['stream_registers']} registers, "
          f"{rec['stream_spill_bytes']} B spilled); library (xp.T @ dw, "
          f"addcmul_, xg @ u) {rec['stream_library_ms']:.4f} ms; M0 from a "
          f"float64 M0 {rec['m0_f64_rel_err']:.2e} (plain "
          f"{rec['m0_plain_f64_rel_err']:.2e})")


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
    m0_f64 = {"high": m0_f64_errors(xg, u_k, out_k[0])}
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
    check(m0_f64["high"][0] <= F64_RATIO * m0_f64["high"][1],
          f"K2 M0 (fp32 streaming pass) vs a float64 M0: "
          f"{m0_f64['high'][0]:.2e}; the fp32 plain version: "
          f"{m0_f64['high'][1]:.2e} (limit {F64_RATIO:g}x)")
    ms = event_ms(lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw), 20)
    ms_g0 = event_ms(lambda: ss_group_pass_cuda(None, xg, omega, u_k, dw,
                                                True), 20)
    host_ms = median_ms(lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw),
                        10)
    plain_ms = event_ms(lambda: ss_group_pass_plain(xp, xg, omega, u_p, dw),
                         5)
    lib_ms = event_ms(lambda: torch.matmul(Z, omega), 10)
    # The Gram kernel (the wgmma TF32 body) and the streaming pass (the
    # scatter and M0 in one pass), each by its own device time as K2 runs
    # them, the pass on a side stream beside the Gram, by torch.profiler;
    # the library sequence of the streaming pass.
    ks, k2_kernels = call_kernels(
        lambda: ss_group_pass_cuda(xp, xg, omega, u_k, dw), 20)
    gram_ms = sum(t for k, t in ks.items() if "group_pass_tf32_kernel" in k)
    s_ms = {"high": sum(t for k, t in ks.items()
                        if "stream_pass_kernel" in k)}
    check(gram_ms > 0, "K2 high: the profiler saw its wgmma TF32 Gram kernel")
    check(s_ms["high"] > 0 and not any(
        "m0_tc" in k or "scatter_kernel" in k for k in k2_kernels),
          f"K2 high: the profiler saw its streaming pass and no other "
          f"scatter or M0 kernel ({k2_kernels})")
    s_lib = {"high": stream_lib_ms(xp, xg, omega, u0, dw, 10)}
    npair = GB * (GB + 1) // 2
    # xp, xg, omega, u in and out, dw; M0, packed Gram, sum omega out. The
    # Gram's FMAs as three TF32 products at the tensor cores' peak
    # (precision "high"); the scatter's and M0's (2 T N GB operations each)
    # in fp32.
    k2_bytes = 4 * (2 * GB * T + 3 * T * N + GB * N + (GB + npair + 1) * N)
    m0_scatter = ((2 * T * N * GB, FP32_FLOPS),
                  (2 * T * N * GB, FP32_FLOPS))
    # The streaming pass: xp, xg, u in and out, omega, dw in, M0 out.
    pass_bytes = 4 * (2 * GB * T + 2 * T * N + 2 * GB * N)
    s_bound = {"high": bound(pass_bytes + 4 * T * N, *m0_scatter)}
    gram_bound = bound(4 * (GB * T + T * N + npair * N),
                       (3 * 2 * T * N * npair, TF32_FLOPS))
    regs = kernel_regs("group_pass_tf32_kernel") or {}
    s_regs = {"high": kernel_regs(STREAM_MIDDLE.format("f")) or {}}
    record["ss_group_pass"].update(
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        precision="high", ms_g0=ms_g0, host_ms=host_ms, f64_rel_err=e_k,
        plain_f64_rel_err=e_p, gram_ms=gram_ms,
        gram_bound_ms=gram_bound["bound_ms"],
        gram_bound_by=gram_bound["bound_by"],
        gram_registers=regs.get("registers"),
        gram_spill_bytes=regs.get("spill_bytes"),
        library_whole_ms=lib_ms + s_lib["high"],
        **stream_fields("high", s_ms, s_bound, s_lib, s_regs, m0_f64,
                        k2_kernels),
        **bound(k2_bytes, (3 * 2 * T * N * npair, TF32_FLOPS), *m0_scatter))
    rec = record["ss_group_pass"]
    print(f"  K2 {ms:.3f} ms per middle group, {ms_g0:.3f} at g = 0 (no "
          f"scatter); {host_ms:.3f} ms per synchronised call on the host "
          f"clock; the Gram kernel alone {gram_ms:.4f} ms (profiler; bound "
          f"{gram_bound['bound_ms']:.4f} ms, {gram_bound['bound_by']}; "
          f"{regs.get('registers')} registers, {regs.get('spill_bytes')} B "
          f"spilled); plain {plain_ms:.3f} ms, library (fp32 "
          f"matmul on the materialised Z) {lib_ms:.3f} ms; bound "
          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, 3xTF32); kernels "
          f"{k2_kernels}")
    print_stream("high", rec)

    # --- K2 "default" and "sr" at the same group, on omega's bf16 stream
    # alone, made once as the fused loop makes it once per update: the
    # scatter, sum_t omega and the wgmma Gram all read it, as the TPU
    # kernel streams its one bf16 omega (ss_pallas.py:409-413) ------------
    om16 = to_bf16(omega)
    om_s = omega_bf16_stream(omega)
    u_k, u_p = u0.clone(), u0.clone()
    out_k = ss_group_pass_cuda(xp, xg, None, u_k, dw, True,
                               precision="default", om16=om_s)
    out_p = ss_group_pass_plain(xp, xg, None, u_p, dw, True,
                                precision="default", om16=om_s)
    m0_f64["default"] = m0_f64_errors(xg, u_k, out_k[0])
    # The scatter on the widened stream is the fp32 scatter of "high" on the
    # float32 rounded omega, bit for bit (and so is M0, which reads u).
    u_h = u0.clone()
    out_h = ss_group_pass_cuda(xp, xg, om16, u_h, dw, True)
    stream_same = {"default": torch.equal(u_k, u_h)
                   and torch.equal(out_k[0], out_h[0])
                   and torch.equal(out_k[2], out_h[2])}
    del out_h
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
    again = ss_group_pass_cuda(xp, xg, None, u0.clone(), dw, True,
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
    out_k = ss_group_pass_cuda(xp, xg, None, u_k, dw, True, precision="sr",
                               sr_seed=sr_seed, om16=om_s)
    out_p = ss_group_pass_plain(xp, xg, None, u_p, dw, True, precision="sr",
                                r16=r16, om16=om_s)
    m0_f64["sr"] = m0_f64_errors(xg, u_k, out_k[0])
    other = ss_group_pass_cuda(xp, xg, None, u0.clone(), dw, precision="sr",
                               sr_seed=(sr_seed[0] + 1, sr_seed[1]),
                               om16=om_s)[1]
    again = ss_group_pass_cuda(xp, xg, None, u0.clone(), dw, True,
                               precision="sr", sr_seed=sr_seed, om16=om_s)
    check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
          "K2 sr repeats bit for bit")
    del again
    u_h = u0.clone()
    out_h = ss_group_pass_cuda(xp, xg, om16, u_h, dw, True)
    stream_same["sr"] = (torch.equal(u_k, u_h)
                         and torch.equal(out_k[0], out_h[0])
                         and torch.equal(out_k[2], out_h[2]))
    del out_h, u_h
    for prec, same in stream_same.items():
        check(same, f"K2 {prec} on the bf16 omega stream alone: u, M0 and "
              f"sum_omega equal bit for bit to K2 \"high\"'s fp32 scatter "
              f"on the float32 rounded omega")
        e_m, e_mp = m0_f64[prec]
        check(e_m <= F64_RATIO * e_mp,
              f"K2 {prec} M0 vs a float64 M0: {e_m:.2e}; the fp32 plain "
              f"version: {e_mp:.2e} (limit {F64_RATIO:g}x)")
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

    times, gram_ms, names = {}, {}, {}
    for prec in ("default", "sr", "sr", "default"):
        times.setdefault(prec, []).append(event_ms(
            lambda: ss_group_pass_cuda(xp, xg, None, u_k, dw, precision=prec,
                                       sr_seed=sr_seed, om16=om_s), 20))
    for prec, inst in (("default", "<false>"), ("sr", "<true>")):
        ks, names[prec] = call_kernels(
            lambda: ss_group_pass_cuda(xp, xg, None, u_k, dw, precision=prec,
                                       sr_seed=sr_seed, om16=om_s), 20)
        gram_ms[prec] = sum(t for k, t in ks.items()
                            if f"group_pass_wgmma_kernel{inst}" in k)
        s_ms[prec] = sum(t for k, t in ks.items()
                         if "stream_pass_kernel" in k)
        check(gram_ms[prec] > 0,
              f"K2 {prec}: the profiler saw its wgmma Gram kernel")
        check(s_ms[prec] > 0 and not any(
            "m0_tc" in k or "scatter_kernel" in k for k in names[prec]),
              f"K2 {prec}: the profiler saw its streaming pass and no other "
              f"scatter or M0 kernel ({names[prec]})")
        s_lib[prec] = stream_lib_ms(xp, xg, om16, u0, dw, 10)
        s_bound[prec] = bound(pass_bytes + 2 * om_s.numel(), *m0_scatter)
        s_regs[prec] = kernel_regs(STREAM_MIDDLE.format("t")) or {}
    # The scatter alone (the epilogue: no Gram or M0 beside it), on the
    # float32 rounded omega as at "high" and on the bf16 stream, in turns.
    epi = {}
    for key in ("fp32", "bf16", "bf16", "fp32"):
        epi.setdefault(key, []).append(event_ms(
            (lambda: ss_group_pass_cuda(xg, None, om16, u_k, dw))
            if key == "fp32" else
            (lambda: ss_group_pass_cuda(xg, None, None, u_k, dw,
                                        precision="default", om16=om_s)),
            20))
    scatter_bytes = 4 * (GB * T + 2 * T * N + GB * N)
    epi_bound = {"fp32": bound(scatter_bytes + 4 * T * N)["bound_ms"],
                 "bf16": bound(scatter_bytes + 2 * om_s.numel())["bound_ms"]}
    print(f"  K2's scatter alone (epilogue): on the bf16 stream {epi['bf16']}"
          f" ms (bound {epi_bound['bf16']:.4f}), on the float32 omega "
          f"{epi['fp32']} ms (bound {epi_bound['fp32']:.4f}; order fp32, "
          f"bf16, bf16, fp32)")
    plain_ms = event_ms(lambda: ss_group_pass_plain(
        xp, xg, None, u_p, dw, precision="default", om16=om_s), 5)
    plain_sr_ms = event_ms(lambda: ss_group_pass_plain(
        xp, xg, None, u_p, dw, precision="sr", r16=r16, om16=om_s), 5)
    del r16
    lib_ms, lib_out = bf16_matmul_ms(to_bf16(Z), om16, 10)
    del Z
    # The bf16 Gram over the bf16 peak; M0 and the scatter fp32. Bytes:
    # as at "high", but omega is the bf16 stream, read once at 2 bytes a
    # (padded) lane. streamed: the bytes as K2 moves them, u read and
    # written once by the streaming pass, X_g and the stream read by the
    # pass and by the Gram.
    k2_bytes16 = (k2_bytes - 4 * T * N + 2 * om_s.numel())
    k2_bound = bound(k2_bytes16, (2 * T * N * npair, BF16_FLOPS),
                     *m0_scatter)
    streamed = bound(4 * (3 * GB * T + 2 * T * N + GB * N
                          + (GB + npair + 1) * N) + 2 * 2 * om_s.numel())
    gram_bound = bound(4 * GB * T + 2 * om_s.numel() + 4 * npair * N,
                       (2 * T * N * npair, BF16_FLOPS))
    for key, prec, pms in (("ss_group_pass_bf16", "default", plain_ms),
                           ("ss_group_pass_sr", "sr", plain_sr_ms)):
        record[key].update(
            ms=min(times[prec]), plain_ms=pms, library_ms=lib_ms,
            library_out=lib_out, precision=prec, gram_ms=gram_ms[prec],
            gram_bound_ms=gram_bound["bound_ms"],
            gram_bound_by=gram_bound["bound_by"],
            streamed_bound_ms=streamed["bound_ms"],
            epilogue_ms=min(epi["bf16"]), epilogue_bound_ms=epi_bound["bf16"],
            epilogue_fp32_ms=min(epi["fp32"]),
            epilogue_fp32_bound_ms=epi_bound["fp32"],
            library_whole_ms=lib_ms + s_lib[prec],
            **stream_fields(prec, s_ms, s_bound, s_lib, s_regs, m0_f64,
                            names[prec]), **k2_bound)
    print(f"  K2 default {times['default']} ms, sr {times['sr']} ms per "
          f"middle group (order default, sr, sr, default); the Gram kernel "
          f"alone {gram_ms['default']:.4f} / {gram_ms['sr']:.4f} ms "
          f"(profiler; bound {gram_bound['bound_ms']:.4f} ms, "
          f"{gram_bound['bound_by']}); plain "
          f"{plain_ms:.3f} / {plain_sr_ms:.3f} ms; library (bf16 cuBLAS on "
          f"the materialised bf16 Z, {lib_out} output) {lib_ms:.3f} ms; "
          f"bound {k2_bound['bound_ms']:.4f} ms ({k2_bound['bound_by']}; "
          f"{streamed['bound_ms']:.4f} ms for the bytes as K2 streams them)")
    for prec in ("default", "sr"):
        print_stream(prec, record[{"default": "ss_group_pass_bf16",
                                   "sr": "ss_group_pass_sr"}[prec]])
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
    from pyglm_tpu_torch.ops.linalg import sample_gamma
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
    phase_k5(check, record, gen, y)


def phase_k5(check, record, gen, y_nb):
    """K5's two forms: the law at CRT_GRID against the exact law and the
    plain version; both forms equal to the numpy twin's draws bit for bit
    at small shapes (N = 27, 200 and, past the sums form's shared column
    table, 60000) and at (T, N) on the NB flagship's counts and on a
    high-count shape (mean ~4.5, max_y 64), where each warp walks many
    chunks; each form bit-repeatable; the law's z there; device time by
    torch.profiler (CUDA events beside it), the plain versions' times and
    the per-element form summed by torch.sum (the sums form's
    alternative). The per-element form's launches: the public
    ``ops.linalg.crt_sample`` at the NB flagship's shape (the models call
    the sums form, whose launches come from the NB paths)."""
    import numpy as np
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch.diagnostics.timing import crt_z
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.crt_cuda import (
        crt_sample_cuda, crt_sample_sums_cuda, crt_sample_twin)
    from pyglm_tpu_torch.ops.linalg import (
        crt_sample, crt_sample_plain, sample_gamma)

    dev = "cuda"
    print("K5 crt_sample / crt_sample_sums: exact law, the numpy twin, then "
          "(100000, 200)", flush=True)
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

    # the twin, bit for bit, at config 1's and the flagship's widths, and
    # at stacked lanes past the sums form's shared column table
    rng = np.random.default_rng(15)
    for t_, n_ in ((301, 27), (301, 200), (5, 60_000)):
        yn = rng.poisson(3.0, (t_, n_)).astype(np.int32)
        yn[::5, ::4] += 40                   # past max_y = 16
        rn = rng.uniform(0.2, 6.0, n_).astype(np.float32)
        want = crt_sample_twin(yn, rn, 16, 2 ** 40 + n_, 9)
        yc, rc = torch.from_numpy(yn).to(dev), torch.from_numpy(rn).to(dev)
        same = all(np.array_equal(crt_sample_cuda(yy, rc, 16, 2 ** 40 + n_,
                                                  9).cpu().numpy(), want)
                   for yy in (yc, yc.float()))
        sums = crt_sample_sums_cuda(yc, rc, 16, 2 ** 40 + n_, 9).cpu()
        check(same and np.array_equal(sums.numpy(), want.sum(0)),
              f"K5 at ({t_}, {n_}) (int and float y, counts past max_y): both "
              f"forms equal the numpy twin bit for bit")

    r = 0.5 + 4.0 * torch.rand((N,), generator=gen, device=dev)
    psi = 0.5 * torch.randn((T, N), generator=gen, device=dev)
    lam = sample_gamma(torch.full((T, N), 4.0, device=dev), gen) * psi.exp()
    y_hi = torch.poisson(lam, generator=gen).to(torch.int32)
    del psi, lam
    shapes = {"nb": (y_nb.to(torch.int32), 16), "high": (y_hi, 64)}
    times, sums_err = {}, 0
    rn = r.cpu().numpy()
    for name, (yi, max_y) in shapes.items():
        want = crt_sample_twin(yi.cpu().numpy(), rn, max_y, 5, 1)
        l = crt_sample_cuda(yi, r, max_y, 5, 1)
        s = crt_sample_sums_cuda(yi, r, max_y, 5, 1)
        twin = (np.array_equal(l.cpu().numpy(), want) and torch.equal(
            crt_sample_cuda(yi.float(), r, max_y, 5, 1), l))
        err = int(np.abs(s.cpu().numpy() - want.sum(0, dtype=np.int64)).max())
        sums_err = max(sums_err, err)
        rep = (torch.equal(l, crt_sample_cuda(yi, r, max_y, 5, 1))
               and torch.equal(s, crt_sample_sums_cuda(yi, r, max_y, 5, 1)))
        z = crt_z(s, yi, r, max_y)
        m = float(yi.clamp(max=max_y).float().mean())
        check(twin and err == 0 and rep and abs(z) < 5.0,
              f"K5 at ({T}, {N}), {name} counts (mean {m:.3f}, max_y "
              f"{max_y}): the per-element form (int and float y) equals the "
              f"numpy twin bit for bit, the sums' max |diff| from the twin's "
              f"column sums {err}, both forms bit-repeatable, the sums' z "
              f"against the exact law {z:.3f} (|z| < 5)")
        del l, want
        n_tr = float(yi.clamp(max=max_y).sum())
        t = times[name] = {
            "ms": kernel_ms(lambda: crt_sample_cuda(yi, r, max_y, 5, 2), 20,
                            "crt"),
            "event_ms": event_ms(lambda: crt_sample_cuda(yi, r, max_y, 5, 2),
                                 20),
            "sums_ms": kernel_ms(lambda: crt_sample_sums_cuda(
                yi, r, max_y, 5, 2), 20, "crt"),
            "sums_event_ms": event_ms(lambda: crt_sample_sums_cuda(
                yi, r, max_y, 5, 2), 20),
            # every kernel of a call: the sums form with its zero fill, and
            # the per-element form with torch.sum over T
            "sums_all_ms": kernel_ms(lambda: crt_sample_sums_cuda(
                yi, r, max_y, 5, 2), 20, ""),
            "summed_ms": kernel_ms(lambda: crt_sample_cuda(
                yi, r, max_y, 5, 2).sum(0), 20, ""),
            # y in and counts out (int32), r; the data's sum of min(y,
            # max_y) Bernoulli draws, ~3 operations each. The sums form
            # writes 8 bytes a column.
            "bound": bound(4 * (2 * T * N + N), (3 * n_tr, FP32_FLOPS)),
            "sums_bound": bound(4 * T * N + 12 * N, (3 * n_tr, FP32_FLOPS))}
        if name == "nb":
            t["plain_ms"] = event_ms(
                lambda: crt_sample_plain(yi, r, max_y, gen), 3)
            t["sums_plain_ms"] = event_ms(
                lambda: crt_sample_plain(yi, r, max_y, gen).sum(0), 3)
        print(f"  K5 {name} counts: per element {t['ms']:.5f} ms (events "
              f"{t['event_ms']:.5f}), bound {t['bound']['bound_ms']:.5f} "
              f"({t['bound']['bound_by']}); sums {t['sums_ms']:.5f} ms "
              f"(events {t['sums_event_ms']:.5f}), bound "
              f"{t['sums_bound']['bound_ms']:.5f}; a call's kernels: sums "
              f"{t['sums_all_ms']:.5f}, per element + torch.sum "
              f"{t['summed_ms']:.5f}"
              + (f"; plain {t['plain_ms']:.3f} / {t['sums_plain_ms']:.3f}"
                 if name == "nb" else ""), flush=True)
    nb, hi = times["nb"], times["high"]
    record["crt_sample"].update(
        max_abs_err=worst, ms=nb["ms"], event_ms=nb["event_ms"],
        plain_ms=nb["plain_ms"], library_ms=None, high_ms=hi["ms"],
        high_event_ms=hi["event_ms"],
        high_bound_ms=hi["bound"]["bound_ms"], **nb["bound"])
    record["crt_sample_sums"].update(
        max_abs_err=sums_err, ms=nb["sums_ms"], event_ms=nb["sums_event_ms"],
        plain_ms=nb["sums_plain_ms"], library_ms=None,
        high_ms=hi["sums_ms"], high_event_ms=hi["sums_event_ms"],
        high_bound_ms=hi["sums_bound"]["bound_ms"],
        all_kernels_ms=nb["sums_all_ms"],
        per_element_summed_ms=nb["summed_ms"], **nb["sums_bound"])
    print("  (max_abs_err: the per-element form's largest |mean diff| from "
          "plain over the grid; the sums form's largest |diff| from the numpy "
          "twin's column sums at both count sets)")

    # the per-element form through the public crt_sample at the NB
    # flagship's counts
    host = torch.Generator().manual_seed(3)
    _build.reset_launches()
    l = crt_sample(y_nb, r, 16, host)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches["crt_sample"] == 1 and sum(launches.values()) == 1
          and l.shape == (T, N) and l.dtype == torch.int32,
          "ops.linalg.crt_sample at (100000, 200): K5's per-element form "
          "launched once, int32 counts")
    _add_launches(record, launches)


def phase_native_oracle(check):
    """K1 and K4 against the port's exact host sampler
    (``pyglm_tpu_torch/native``: Polson, Scott and Windle's Devroye-type
    sampler on std::mt19937_64, built here with g++; the phase fails if it
    cannot be built): K1 at each c of ORACLE_C1, K4 at each whole b and c
    of ORACLE_BC4, ORACLE_DRAWS draws each, two-sample KS p > KS_P_MIN; the
    oracle on every host core."""
    import numpy as np
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch import native
    from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda

    t0 = time.perf_counter()
    native.library()                   # raises if the oracle cannot build
    threads = os.cpu_count() or 1
    n = ORACLE_DRAWS
    print(f"native oracle: built and loaded in {time.perf_counter() - t0:.2f}"
          f" s; K1 and K4 against it, {n} draws each, {threads} host "
          f"threads", flush=True)

    def ks(label, k, o):
        res = ks_2samp(k, o)
        check(res.pvalue > KS_P_MIN and np.isfinite(k).all() and (k > 0).all(),
              f"{label} vs the native oracle: KS D={res.statistic:.5f} "
              f"p={res.pvalue:.4f}; means {k.mean():.6f} / {o.mean():.6f}")

    for i, c in enumerate(ORACLE_C1):
        k = pg_devroye_cuda(torch.full((n,), c, device="cuda"), 300 + i,
                            0).cpu().numpy()
        o = native.pg_devroye_native(np.full(n, c), seed=31 + i,
                                     n_threads=threads)
        ks(f"K1 PG(1, {c})", k, o)
    for i, (b, c) in enumerate(ORACLE_BC4):
        k = pg_gamma_series_cuda(torch.full((n,), float(b), device="cuda"),
                                 torch.full((n,), c, device="cuda"), 400 + i,
                                 0).cpu().numpy()
        o = native.pg_int_b_native(np.full(n, float(b)), c, seed=41 + i,
                                   n_threads=threads)
        ks(f"K4 PG({b}, {c})", k, o)


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
          and launches["crt_sample_sums"] == 0
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


# Acceptance config 1 (benchmarks/acceptance.py): the dense Bernoulli GLM.
N1, T1 = 27, 60_000
# The stacked dense ensemble's chains.
C1 = 8


def _timed_sweeps(model, n):
    """n sweeps of `model` after the launch counts are set to 0: (seconds
    on the host clock ending in a synchronize, launch counts, lls)."""
    import torch
    from pyglm_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    lls = [model.resample_model()["log_likelihood"] for _ in range(n)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(_build.LAUNCHES), lls


def _add_launches(record, launches):
    for name in KERNELS:
        record[name]["launches"] += launches[name]


def phase_dense(check, record, ctx):
    """Acceptance config 1 at full width through the user entry points:
    its truth generates T1 + T1/10 bins (kept for phase_acceptance), a
    BernoulliGLM fits the first T1 (2 warm-up + N_TIMED timed sweeps: K1
    and the fp32 dense update); one dense update on the card against the
    CPU on the same PG draws and normals; the stacked dense ensemble (C1
    chains); then NegativeBinomialGLM (K4, and K5 when stacked) and
    BinomialGLM (K4) on counts at the same shape."""
    import math
    import numpy as np
    import torch
    from pyglm_tpu_torch import (
        BernoulliGLM, BinomialGLM, NegativeBinomialGLM)
    from pyglm_tpu_torch import acceptance as acc
    from pyglm_tpu_torch.models.weights import (
        pack_weights, resample_dense, sufficient_stats)
    from pyglm_tpu_torch.ops import _build

    print(f"dense: config 1, BernoulliGLM N={N1}, T={T1}", flush=True)
    true = acc.make_truth("1_bernoulli_dense", "cuda")
    Y, gen_s = acc.simulate(true, T1 + T1 // 10)
    ctx["c1"] = (true, Y)
    print(f"  truth generates {len(Y)} bins in {gen_s:.2f} s, rate "
          f"{Y.mean():.4f}")
    m = BernoulliGLM(N1, B=B, L=L, seed=0, device="cuda")
    m.add_data(Y[:T1])
    for _ in range(N_WARMUP):
        m.resample_model()
    dt, launches, lls = _timed_sweeps(m, N_TIMED)
    print(f"  {N_TIMED} timed sweeps: {dt:.3f} s = {N_TIMED / dt:.3f} "
          f"sweeps/s; lls {[round(x, 1) for x in lls]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(launches["pg_devroye"] == N_TIMED
          and sum(launches.values()) == N_TIMED,
          "the dense Bernoulli sweep launches K1 once and no other kernel")
    check(all(math.isfinite(x) for x in lls) and (m.A == 1).all(),
          "dense log-likelihoods finite, A all ones")
    _add_launches(record, launches)
    out = {"dense_c1_sweeps_per_s": N_TIMED / dt}

    # The dense update on the card and on the CPU from one state, one set
    # of PG draws (K1's) and one set of normals.
    d = m.datas[0]
    w = pack_weights(m.state.A, m.state.W, m.state.b)
    omega, kappa = m.observation.omega_kappa(m.generators.host, d.Y,
                                             d.Xf @ w, None)
    P1 = N1 * B + 1
    eps = torch.randn((N1, P1), generator=torch.Generator().manual_seed(8))
    w_dev = {}
    for dev in ("cuda", "cpu"):
        J, h = sufficient_stats(d.Xf.to(dev), omega.to(dev), kappa.to(dev))
        w_dev[dev] = resample_dense(None, J, h,
                                    m.network.edge_hypers(m.state.net, dev),
                                    B, eps=eps.to(dev))
    err = rel_err(w_dev["cuda"].cpu(), w_dev["cpu"])
    check(err <= 1e-3, f"dense update card vs CPU on the same noise: "
          f"max|diff w| / max|w| = {err:.2e} (limit 1e-3)")

    t0 = time.perf_counter()
    _build.reset_launches()
    ens = m.fit_ensemble(n_chains=C1, n_burnin=1, n_samples=4,
                         collect="mean")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"  stacked dense ensemble, {C1} chains: 5 stacked sweeps in "
          f"{dt:.3f} s = {C1 * 5 / dt:.2f} chain-sweeps/s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(launches["pg_devroye"] == 5 and np.isfinite(ens["lls"]).all(),
          "the stacked dense sweep: K1 once a stacked sweep, lls finite")
    _add_launches(record, launches)
    out["dense_c1_ensemble_chain_sweeps_per_s"] = C1 * 5 / dt

    rng = np.random.default_rng(1)
    counts = np.minimum(rng.negative_binomial(4, 0.9, (T1, N1)), 15)
    for cls, kw, data, key in (
            (NegativeBinomialGLM, dict(obs_kwargs=dict(max_y=16)), counts,
             "nb"),
            (BinomialGLM, dict(obs_kwargs=dict(n_trials=3)),
             rng.binomial(3, 0.1, (T1, N1)), "binomial")):
        mm = cls(N1, B=B, L=L, seed=0, device="cuda", **kw)
        mm.add_data(data)
        mm.resample_model()
        dt, launches, lls = _timed_sweeps(mm, 3)
        print(f"  {cls.__name__}: 3 sweeps {dt:.3f} s; lls "
              f"{[round(x, 1) for x in lls]}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(launches["pg_gamma_series"] == 3
              and all(math.isfinite(x) for x in lls),
              f"{cls.__name__}: K4 once a sweep, lls finite")
        _add_launches(record, launches)
        out[f"dense_{key}_sweeps_per_s"] = 3 / dt
        if key == "nb":
            _build.reset_launches()
            ens = mm.fit_ensemble(n_chains=C1, n_samples=4, collect="mean")
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            check(launches["crt_sample_sums"] == 4
                  and launches["crt_sample"] == 0
                  and launches["pg_gamma_series"] == 4
                  and np.isfinite(ens["lls"]).all(),
                  f"stacked dense NB ({C1} chains): K4 and K5's sums form "
                  f"once a stacked sweep ({launches['pg_gamma_series']}, "
                  f"{launches['crt_sample_sums']} for 4), lls finite")
            _add_launches(record, launches)
    return out


# Acceptance config 4: the SBM prior, K=5.
N4, T4 = 100, 40_000
SBM_GRAMS = {"high": "ss_group_pass", "default": "ss_group_pass_bf16",
             "sr": "ss_group_pass_sr"}


def phase_sbm(check, record, ctx):
    """Acceptance config 4 at full width through the user entry points: its
    truth generates T4 + T4/10 bins (kept for phase_acceptance); the fitted
    model (SBM, K=5) runs 1 warm-up and N_TIMED timed sweeps at "high",
    "default" and "sr" on the fused loop (G=10, GB=40), with the SBM
    resample and its label scan timed apart on the host clock."""
    import math
    import numpy as np
    from pyglm_tpu_torch import acceptance as acc
    from pyglm_tpu_torch.models import weights

    print(f"sbm: config 4, N={N4}, K={acc.K4}, T={T4}", flush=True)
    true = acc.make_truth("4_sbm", "cuda")
    Y, gen_s = acc.simulate(true, T4 + T4 // 10)
    ctx["c4"] = (true, Y)
    print(f"  truth generates {len(Y)} bins in {gen_s:.2f} s, rate "
          f"{Y.mean():.4f}, {int(true.A.sum())} true edges")
    out = {}
    for prec, key in SBM_GRAMS.items():
        m = acc.make_model("4_sbm", prec, "cuda")
        m.add_data(Y[:T4])
        m.resample_model()
        weights.LAST_SS_PATH = None
        dt, launches, lls = _timed_sweeps(m, N_TIMED)
        ng = N4 // m.group
        st, net = m.state, m.network
        t0 = time.perf_counter()
        for _ in range(3):
            net.resample(m.generators, st.net, st.A, st.W)
        net_ms = (time.perf_counter() - t0) / 3 * 1e3
        tabs = [x.double().cpu().numpy() for x in
                net._scan_tables(net._edge_tables(st.net, st.A, st.W))]
        u = np.random.default_rng(0).random(N4)
        t0 = time.perf_counter()
        for _ in range(3):
            net._label_scan(*tabs, st.net.c.numpy(),
                            st.net.pi.double().numpy(), u)
        scan_ms = (time.perf_counter() - t0) / 3 * 1e3
        sweep_ms = dt / N_TIMED * 1e3
        print(f"  {prec!r}: {N_TIMED} sweeps {dt:.3f} s = "
              f"{N_TIMED / dt:.3f} sweeps/s; the SBM resample {net_ms:.2f} "
              f"ms ({net_ms / sweep_ms:.3f} of a sweep), its label scan "
              f"{scan_ms:.2f} ms ({scan_ms / sweep_ms:.3f}); lls "
              f"{[round(x, 1) for x in lls]}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; loop "
              f"{weights.LAST_SS_PATH}")
        check(weights.LAST_SS_PATH == "fused"
              and launches[key] == N_TIMED * (ng + 1)
              and launches["ss_edge_scan"] == N_TIMED * ng
              and launches["pg_devroye"] == N_TIMED,
              f"config 4 at {prec!r}: the fused loop, {key} {ng + 1} and K3 "
              f"{ng} and K1 1 per sweep")
        check(all(math.isfinite(x) for x in lls), "lls finite")
        _add_launches(record, launches)
        out[f"sbm_{prec}_sweeps_per_s"] = N_TIMED / dt
        out[f"sbm_{prec}_resample_ms"] = net_ms
        out[f"sbm_{prec}_label_scan_ms"] = scan_ms
        if prec == "high":
            _sbm_update_card_vs_cpu(check, m, Y[:T4])
    return out


def _sbm_update_card_vs_cpu(check, mc, Y):
    """One spike-and-slab update of config 4's model `mc` at full width on
    the card (the fused loop at "high": K2 + K3) and on the CPU (their
    plain versions) from the same state, PG draws (K1's, copied) and
    noise; then the SBM resample from the CPU update's (A, W) on each
    device with one host generator seed. A and the labels identical; w
    within REL_TOL of max |w| or, where larger, 10x the CPU update's own
    change when psi is rounded from float64 instead of a float32 GEMM (as
    phase_small_parity bounds NB's; at this width the edges that are on
    make the update's w that sensitive)."""
    import torch
    from pyglm_tpu_torch import acceptance as acc
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.ensemble import chain_generators
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, pack_weights, resample_spike_slab_tspace,
        unpack_weights)
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

    mh = acc.make_model("4_sbm", "high", "cpu")
    mh.add_data(Y)
    s = state_to_numpy(mc.state)
    mh.state = state_from_numpy(s["A"], s["W"], s["b"], s["net"],
                                device="cpu", network=mh.network)
    G_ = mc.group
    ng = N4 // G_
    gen = torch.Generator().manual_seed(5)
    noise = SpikeSlabNoise(torch.rand((ng, G_, N4), generator=gen),
                           torch.randn((ng, G_, N4, B), generator=gen),
                           torch.randn((N4,), generator=gen))
    dc = mc.datas[0]
    w_c = pack_weights(mc.state.A, mc.state.W, mc.state.b)
    psi_c = dc.Xf @ w_c
    omega, kappa = mc.observation.omega_kappa(mc.generators.host, dc.Y,
                                              psi_c, None)
    def update(m, dev, psi=None):
        d = m.datas[0]
        w = pack_weights(m.state.A, m.state.W, m.state.b)
        return resample_spike_slab_tspace(
            None, d.Xt, omega.to(dev), kappa.to(dev),
            d.Xf @ w if psi is None else psi, w,
            m.network.edge_hypers(m.state.net, dev), B, group=G_,
            noise=SpikeSlabNoise(*(x.to(dev) for x in noise[:3])),
            precision="high")
    outs = [update(mc, "cuda")]
    path = weights.LAST_SS_PATH
    outs.append(update(mh, "cpu"))
    dh = mh.datas[0]
    w_h = pack_weights(mh.state.A, mh.state.W, mh.state.b)
    out_64 = update(mh, "cpu", (dh.Xf.double() @ w_h.double()).float())
    w_tol = max(REL_TOL, 10 * rel_err(out_64[1], outs[1][1]))
    n_diff = int((outs[0][0].cpu() != outs[1][0]).sum())
    werr = rel_err(outs[0][1].cpu(), outs[1][1])
    print(f"  config 4 update, card vs CPU at 'high': {n_diff} of {N4 * N4} "
          f"edges differ ({int(outs[1][0].sum())} on), w {werr:.2e}; the "
          f"CPU's own sensitivity to rounding psi {w_tol / 10:.2e}; loop "
          f"{path}", flush=True)
    check(path == "fused" and n_diff == 0 and werr <= w_tol,
          f"config 4 update on the card (fused loop) against the CPU, same "
          f"noise: A identical, w {werr:.2e} (limit {w_tol:.2e})")
    A_h, W_h = outs[1][0], unpack_weights(outs[1][1], N4, B)[0]
    nets = [m.network.resample(chain_generators(6, dev), m.state.net,
                               A_h.to(dev), W_h.to(dev))
            for m, dev in ((mc, "cuda"), (mh, "cpu"))]
    n_lab = int((nets[0].c != nets[1].c).sum())
    close = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                for a, b in zip(nets[0][1:], nets[1][1:]))
    check(n_lab == 0 and close,
          f"config 4 SBM resample card vs CPU: labels identical ({n_lab} of "
          f"{N4} differ), pi, rho, mu, Sigma within 1e-5")


# The model surface's classes: (class name, family data, constructor
# arguments); "default" is NonlinearAutoregressiveModel with its defaults.
SURFACE = (("default", "spikes", {}), ("BernoulliGLM", "spikes", {}),
           ("GaussianGLM", "gauss", {}), ("SparseGaussianGLM", "gauss", {}),
           ("NegativeBinomialGLM", "counts", dict(obs_kwargs=dict(
               max_y=16))),
           ("BinomialGLM", "counts", dict(obs_kwargs=dict(n_trials=3))),
           ("sbm", "spikes", dict(network="sbm", spike_and_slab=True,
                                  net_kwargs=dict(K=3))))


def phase_surface(check, record):
    """Each class of the model surface on the card at a small size (N=12,
    T=2000): construct, add_data, fit (3 samples) and fit_ensemble (2
    stacked chains of 4 samples), finite results."""
    import numpy as np
    import pyglm_tpu_torch as ptt
    from pyglm_tpu_torch.ops import _build

    n, t = 12, 2000
    rng = np.random.default_rng(3)
    data = {"spikes": (rng.random((t, n)) < 0.15).astype(np.float32),
            "counts": rng.binomial(3, 0.15, (t, n)).astype(np.float32),
            "gauss": rng.standard_normal((t, n)).astype(np.float32)}
    print(f"surface: every class at N={n}, T={t}: fit and fit_ensemble",
          flush=True)
    _build.reset_launches()
    for name, kind, kw in SURFACE:
        cls = (ptt.NonlinearAutoregressiveModel
               if name in ("default", "sbm") else getattr(ptt, name))
        m = cls(n, B=B, L=L, seed=1, device="cuda", **kw)
        m.add_data(data[kind])
        fit = m.fit(n_samples=3)
        ens = m.fit_ensemble(n_chains=2, n_samples=4)
        ok = (np.isfinite(fit["lls"]).all() and np.isfinite(fit["W"]).all()
              and np.isfinite(ens["lls"]).all()
              and ens["A"].shape == (2, 4, n, n))
        check(ok, f"{name} ({m.observation.name}, {m.network.name}, "
                  f"spike_and_slab={m.spike_and_slab}): fit and "
                  f"fit_ensemble on the card, finite")
    _add_launches(record, dict(_build.LAUNCHES))


def _lagged_noise(gen, T_, N_):
    """(T_, N_) Gaussian data in which neuron n follows neuron perm[n] one
    bin later: y_t = z_t + 0.4 z_{t-1}[perm], z iid N(0, 1), made on the
    card. A Gaussian model finds those edges (a truth's per-bin
    generation would take ~20 s at T=1e5)."""
    import torch
    z = torch.randn((T_ + 1, N_), generator=gen, device="cuda")
    perm = torch.randperm(N_, generator=gen, device="cuda")
    return z[1:] + 0.4 * z[:-1][:, perm]


def phase_gaussian(check, record):
    """SparseGaussianGLM at the flagship's shapes (N=200, T=100k, lagged
    Gaussian data): its cached group Gram (K6 on one lane of ones at
    add_data) against K6's plain version; 1 warm-up and N_TIMED timed
    sweeps (the staged loop on the cached Gram: K3 only); one update on
    the cached Gram against the staged loop forming the Gram (K6) from
    omega = 1/eta, same state and noise. Then GaussianGLM (dense, its full
    Gram cached) at config 1's shape, and one dense update on its cached
    Gram against J and h formed from omega = 1/eta on the same normals."""
    import math
    import torch
    from pyglm_tpu_torch import GaussianGLM, SparseGaussianGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, pack_weights, resample_dense,
        resample_spike_slab_tspace, sufficient_stats)
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.gram_cuda import group_gram_blocks_plain

    print(f"gaussian: SparseGaussianGLM N={N}, T={T}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = SparseGaussianGLM(N, B=B, L=L, seed=0, device="cuda")
    _build.reset_launches()
    t0 = time.perf_counter()
    m.add_data(_lagged_noise(gen, T, N))
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    d = m.datas[0]
    plain = group_gram_blocks_plain(d.Xt, torch.ones((T, 1), device="cuda"),
                                    B, m.group, precision="high")
    err = rel_err(d.Gg0, plain)
    print(f"  add_data {add_s:.3f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }; Gg0 "
          f"{tuple(d.Gg0.shape)}")
    check(launches["group_gram"] == 1 and err <= GRAM_REL_TOL,
          f"Gg0 by K6 (one lane of ones) against its plain version: "
          f"max|diff|/max = {err:.2e} (limit {GRAM_REL_TOL:g})")
    _add_launches(record, launches)
    m.resample_model()
    dt, launches, lls = _timed_sweeps(m, N_TIMED)
    ng = N // m.group
    print(f"  {N_TIMED} timed sweeps: {dt:.3f} s = {N_TIMED / dt:.3f} "
          f"sweeps/s; lls {[round(x, 1) for x in lls]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(weights.LAST_SS_PATH == "staged"
          and launches["ss_edge_scan"] == N_TIMED * ng
          and sum(launches.values()) == N_TIMED * ng,
          f"the cached sparse Gaussian sweep runs the staged loop: K3 {ng} "
          f"a sweep and no other kernel")
    check(all(math.isfinite(x) for x in lls), "lls finite")
    _add_launches(record, launches)
    out = {"gaussian_sweeps_per_s": N_TIMED / dt}

    st = m.state
    w = pack_weights(st.A, st.W, st.b)
    psi = d.Xf @ w
    omega, kappa = m.observation.omega_kappa(None, d.Y, psi, st.aux)
    hyp = m.network.edge_hypers(st.net, "cuda")
    G_ = m.group
    noise = SpikeSlabNoise(
        torch.rand((ng, G_, N), generator=gen, device="cuda"),
        torch.randn((ng, G_, N, B), generator=gen, device="cuda"),
        torch.randn((N,), generator=gen, device="cuda"))
    outs = [resample_spike_slab_tspace(
        None, d.Xt, omega, kappa, psi, w, hyp, B, group=G_, noise=noise,
        precision="high", **kw)
        for kw in (dict(Jg=d.Gg0 / st.aux["eta"]), dict(path="staged"))]
    n_diff = int((outs[0][0] != outs[1][0]).sum())
    werr = rel_err(outs[0][1], outs[1][1])
    print(f"  cached against uncached: {n_diff} of {N * N} edges differ, "
          f"w {werr:.2e}; edges {int(outs[1][0].sum())}")
    check(n_diff == 0 and werr <= REL_TOL and int(outs[1][0].sum()) > 0,
          f"the staged loop on the cached Gram against the staged loop "
          f"forming it: A identical (edges found), w {werr:.2e} (limit "
          f"{REL_TOL:g})")

    gm = GaussianGLM(N1, B=B, L=L, seed=0, device="cuda")
    gm.add_data(_lagged_noise(gen, T1, N1))
    gm.resample_model()
    dt, launches, lls = _timed_sweeps(gm, N_TIMED)
    print(f"  GaussianGLM N={N1}, T={T1}: {N_TIMED} sweeps {dt:.3f} s; "
          f"lls {[round(x, 1) for x in lls]}; launches "
          f"{sum(launches.values())}")
    check(all(math.isfinite(x) for x in lls)
          and bool(torch.isfinite(gm.state.aux["eta"]).all()),
          "GaussianGLM (dense, cached full Gram): lls and eta finite")
    out["gaussian_dense_c1_sweeps_per_s"] = N_TIMED / dt

    # One dense update from the cached full Gram (as the sweep scales it)
    # against J and h formed from omega = 1/eta, on the same normals.
    gd, aux = gm.datas[0], gm.state.aux
    inv_eta = 1.0 / aux["eta"]
    w = pack_weights(gm.state.A, gm.state.W, gm.state.b)
    omega, kappa = gm.observation.omega_kappa(None, gd.Y, gd.Xf @ w, aux)
    hyp = gm.network.edge_hypers(gm.state.net, "cuda")
    eps = torch.randn((N1, gd.Xf.shape[1]), generator=gen, device="cuda")
    w_c = resample_dense(None, gd.Gfull[None] * inv_eta[:, None, None],
                         gd.XtY * inv_eta, hyp, B, eps=eps)
    w_u = resample_dense(None, *sufficient_stats(gd.Xf, omega, kappa), hyp,
                         B, eps=eps)
    err = rel_err(w_c, w_u)
    check(err <= 1e-3, f"GaussianGLM's dense update on its cached Gram "
          f"against J, h from omega = 1/eta, same normals: max|diff w| / "
          f"max|w| = {err:.2e} (limit 1e-3)")
    return out


# The chain-level protocol of benchmarks/sr_parity.py, in
# pyglm_tpu_torch/diagnostics/parity.py: N=8, B=4 (GB=32, so the fused loop
# runs), T=1500, 150 + 400 sweeps. One chain per mode is too noisy (edge
# (3, 0) is bimodal), so each mode runs PAR_C lane-stacked chains from seeds
# of its own and their pooled posterior means compare; a second "high" pool
# on other seeds is the Monte Carlo control. Against the first "high" pool a
# pool's max edge-marginal difference must lie within its permutation band
# (the 0.999 quantile over random splits of the two pools' chains, never
# above 0.22) and every edge's difference within PAR_Z standard errors.
# Each pool is then held to ORC_C f64 oracle chains (the port's copy of the
# NumPy reference, one spawned process per ORC_PROCS, one BLAS thread each)
# at tests/test_numpy_parity.py's tolerances and a per-edge |z| < ORC_Z.
# "high" is held to the same gates: the oracle, not "high", is the
# reference. How often the gates fail pools with no bias:
# python -m pyglm_tpu_torch.diagnostics.parity.
PAR_POOLS = (("high", "high", 1), ("default", "default", 201),
             ("sr", "sr", 301), ("high_control", "high", 101))
ORC_SEED0, ORC_PROCS = 7, 4


# The oracle configs of tests/test_numpy_parity.py that the dense path, the
# Gaussian family and the SBM prior answer to (diagnostics/parity.py::
# ORACLE_CONFIGS, planted data by the port's generator on the CPU): per
# config, a pool of lane-stacked chains on the card (seeds of its own; the
# learned NIW and the SBM resample per chain on the host, so their pools
# are smaller) against ORC_CFG_C oracle chains, at the config's tolerances
# and a per-edge |z| < ORC_Z where A varies.
ORC_CFG = {"dense_niw": 16, "gaussian": 32, "sbm": 8}
ORC_CFG_C, ORC_CFG_SEED0, ORC_CFG_PROCS = 8, 1001, 2


def start_oracle(ctx):
    """Make the parity data and start the oracle chains on it: those of the
    chain-parity data (ORC_PROCS processes) and those of the ORC_CFG
    configs (ORC_CFG_PROCS); they run on the host beside the chain-parity,
    config-parity and Geweke phases."""
    import multiprocessing as mp
    from pyglm_tpu_torch.diagnostics import parity as par
    ctx["par_Y"] = par.parity_data()
    ctx["oracle_pool"], ctx["oracle"] = par.start_oracle(
        ctx["par_Y"], range(ORC_SEED0, ORC_SEED0 + par.ORC_C), ORC_PROCS)
    ctx["cfg_Y"] = {name: par.config_data(name) for name in ORC_CFG}
    pool = mp.get_context("spawn").Pool(ORC_CFG_PROCS)
    ctx["cfg_oracle_pool"] = pool
    ctx["cfg_oracle"] = pool.starmap_async(par.config_oracle_means, [
        (name, ctx["cfg_Y"][name], ORC_SEED0 + i)
        for name in ORC_CFG for i in range(ORC_CFG_C)])
    pool.close()
    ctx["oracle_t0"] = time.perf_counter()


def phase_config_parity(check, ctx):
    """The ORC_CFG pools on the card (lane-stacked chains at "high"); kept
    in ctx["cfg_pools"] for phase_oracle_parity."""
    from pyglm_tpu_torch.diagnostics import parity as par
    pools = {}
    for name, C in ORC_CFG.items():
        cfg = par.ORACLE_CONFIGS[name]
        t0 = time.perf_counter()
        pools[name] = par.config_port_means(
            name, ctx["cfg_Y"][name],
            list(range(ORC_CFG_SEED0, ORC_CFG_SEED0 + C)), device="cuda")
        print(f"config parity: {name} ({cfg.source}), {C} stacked chains, "
              f"{cfg.burn} + {cfg.keep} sweeps in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    ctx["cfg_pools"] = pools


def phase_chain_parity(check, ctx):
    """The pools of PAR_POOLS on the card, each mode's held to the first
    "high" pool. Each chain's posterior means of A, W_effective and the
    bias are kept in ctx["par_pools"] for phase_oracle_parity."""
    import numpy as np
    from pyglm_tpu_torch.diagnostics import parity as par

    print(f"chain parity: N={par.PAR_N}, T={par.PAR_T}, {par.PAR_C} stacked "
          f"chains per mode, {par.PAR_BURN} + {par.PAR_KEEP} sweeps",
          flush=True)
    pools, paths = {}, {}
    t0 = time.perf_counter()
    for name, prec, s0 in PAR_POOLS:
        pools[name], paths[name] = par.parity_pool(ctx["par_Y"], prec, s0)
    dt = time.perf_counter() - t0
    ctx["par_pools"] = pools
    others = [name for name, _, _ in PAR_POOLS[1:]]
    res = {k: par.parity_gates(pools[k], pools["high"])[1] for k in others}
    diff = {k: r["max_edge_marginal_diff"] for k, r in res.items()}
    band = {k: r["band"] for k, r in res.items()}
    zmax = {k: r["max_z"] for k, r in res.items()}
    print(f"  4 pools in {dt:.1f} s (the oracle's chains share the host); "
          f"max edge-marginal diff vs the 'high' pool: {diff}; its band: "
          f"{band}; max |z| over the edges: {zmax}; max weight-mean diff: "
          f"{ {k: r['max_weight_mean_diff'] for k, r in res.items()} }; "
          f"mean edge probability "
          f"{ {k: round(float(v['A'].mean()), 4) for k, v in pools.items()} }"
          f"; loops {paths}")
    check(all(v == "fused" for v in paths.values()),
          "every pool ran the fused loop")
    check(all(diff[k] <= band[k] for k in others),
          f"max edge-marginal diff within the permutation band (level "
          f"{1 - par.PAR_PERM_Q:.3g}, at most {par.PAR_BAND_CAP}): "
          + ", ".join(f"{k} {diff[k]:.3f} <= {band[k]:.3f}" for k in others))
    check(all(z < par.PAR_Z for z in zmax.values()),
          f"every edge within {par.PAR_Z:g} standard errors of the 'high' "
          f"pool: max |z| default {zmax['default']:.2f}, sr "
          f"{zmax['sr']:.2f}, control {zmax['high_control']:.2f}")
    return {"parity_max_edge_diff": diff, "parity_max_z": zmax,
            "parity_band": band, "parity_s": dt}


def phase_oracle_parity(check, ctx):
    """Each pool of phase_chain_parity against the pool of the oracle
    chains (parity.oracle_gates)."""
    import numpy as np
    from pyglm_tpu_torch.diagnostics import parity as par
    res = ctx["oracle"].get(timeout=1800)
    wait = time.perf_counter() - ctx["oracle_t0"]
    ctx.pop("oracle_pool").join()
    orc = par.stack_chains(res)
    secs = [round(r[3], 1) for r in res]
    print(f"oracle parity: {len(res)} f64 oracle chains (seeds "
          f"{ORC_SEED0}..{ORC_SEED0 + len(res) - 1}, {ORC_PROCS} processes), "
          f"{par.PAR_BURN} + {par.PAR_KEEP} sweeps each, "
          f"{min(secs)}..{max(secs)} s each "
          f"({np.mean(secs) / (par.PAR_BURN + par.PAR_KEEP):.3f} s a sweep), "
          f"done {wait:.1f} s after their start", flush=True)
    out = {}
    for name, pool in ctx["par_pools"].items():
        r = out[name] = par.pool_compare(pool, orc)
        print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
        check(par.oracle_gates(r),
              f"{name} pool within the oracle protocol's tolerances "
              f"{par.ORC_TOL} and every edge within {par.ORC_Z:g} standard "
              f"errors")
    res = ctx["cfg_oracle"].get(timeout=1800)
    ctx.pop("cfg_oracle_pool").join()
    print(f"  the configs' oracle chains done "
          f"{time.perf_counter() - ctx['oracle_t0']:.1f} s after their "
          f"start", flush=True)
    for i, name in enumerate(ORC_CFG):
        part = res[i * ORC_CFG_C:(i + 1) * ORC_CFG_C]
        orc_c = {k: np.concatenate([r[0][k] for r in part])
                 for k in part[0][0]}
        r = out[name] = par.config_compare(name, ctx["cfg_pools"][name],
                                           orc_c)
        secs_c = [round(x[1], 1) for x in part]
        print(f"  {name} ({ORC_CFG[name]} port chains vs {ORC_CFG_C} oracle "
              f"chains, {min(secs_c)}..{max(secs_c)} s each): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
        check(par.config_gates(name, r, z_max=par.ORC_Z),
              f"{name} pool within {par.ORACLE_CONFIGS[name].tol} of the "
              f"oracle's and every edge within {par.ORC_Z:g} standard errors")
    return {"oracle_parity": out, "oracle_chain_s": secs}


# The Geweke protocol of tests/test_geweke_tpu.py on the card: the
# successive-conditional simulator at a shape where the fused loop runs
# (N=8, B=4 -> GB=32, T=384), GW_ITERS iterations (4000, as there), the
# first GW_BURN dropped, n_eff discounted by each series' integrated
# autocorrelation time.
# Lanes: Bernoulli at "high" and "sr" (K1 + K2 + K3), NB with the count
# table (K4 + K2 + K3 and the collapsed-CRT r update), Binomial n=5 (K4);
# the dense Gaussian, the SBM and the sparse Gaussian at the `iters` of
# their tests in tests/test_geweke.py (3000).
# No lane at "default": its Gram is biased by design (ss_pallas.py:30-31).
# The lanes run at once, one spawned process each: each is paced by the
# per-bin generation loop on the host, not by the card.
GW_N, GW_T, GW_ITERS, GW_BURN, GW_Z = 8, 384, 4000, 500, 5.0
GW_LANES = {
    "bernoulli_high": dict(seed=7, precision="high", obs=("bernoulli", {}),
                           net=dict(rho_init=0.4, sigma_w=0.25,
                                    mu_bias=-1.5, sigma_bias=0.3)),
    "bernoulli_sr": dict(seed=8, precision="sr", obs=("bernoulli", {}),
                         net=dict(rho_init=0.4, sigma_w=0.25, mu_bias=-1.5,
                                  sigma_bias=0.3)),
    # Subcritical exp-link dynamics (test_geweke_tpu.py: y_max <= ~30).
    "negative_binomial": dict(
        seed=11, precision="high", llc=True,
        obs=("negative_binomial", dict(r_init=2.0, resample_r=True,
                                       a_r=4.0, b_r=2.0, max_y=128)),
        net=dict(rho_init=0.25, sigma_w=0.004, mu_bias=-2.0,
                 sigma_bias=0.2)),
    "binomial": dict(seed=12, precision="high",
                     obs=("binomial", dict(n_trials=5)),
                     net=dict(rho_init=0.4, sigma_w=0.05, mu_bias=-1.0,
                              sigma_bias=0.3)),
    # tests/test_geweke.py:89, :239, :300.
    "gaussian_dense": dict(
        seed=13, precision="high", spike_slab=False, network="dense",
        iters=3000,
        obs=("gaussian", dict(a_eta=6.0, b_eta=2.0, eta_init=0.5)),
        net=dict(learn_weight_prior=False, sigma_w=0.003, mu_bias=0.0,
                 sigma_bias=0.1)),
    # At test_geweke.py's own shape (N=3, B=1, L=3, T=50: the staged loop,
    # K6 + K3): at N=8, B=4 the labels mix too slowly for its gates in
    # both packages (block-0 fraction tau ~250, pi variance ratio ~0.34
    # over 1500 iterations of the JAX package's chain; ROADMAP Queue C).
    "sbm": dict(seed=14, precision="high", network="sbm", N=3, B=1, L=3,
                T=50, path="staged", iters=3000, obs=("bernoulli", {}),
                net=dict(K=2, a_rho=2.0, b_rho=3.0, alpha_pi=1.0,
                         sigma_w=0.5, niw_kappa0=1.0, mu_bias=-1.0,
                         sigma_bias=0.3)),
    "gaussian_sparse": dict(
        seed=15, precision="high", iters=3000,
        obs=("gaussian", dict(a_eta=6.0, b_eta=2.0, eta_init=0.5)),
        net=dict(rho_init=0.4, sigma_w=0.003, mu_bias=0.0,
                 sigma_bias=0.1)),
}
# The kernels each lane must launch (LAUNCHES keys).
GW_KERNELS = {"bernoulli_high": ("pg_devroye", "ss_group_pass",
                                 "ss_edge_scan"),
              "bernoulli_sr": ("pg_devroye", "ss_group_pass_sr",
                               "ss_edge_scan"),
              "negative_binomial": ("pg_gamma_series", "ss_group_pass",
                                    "ss_edge_scan"),
              "binomial": ("pg_gamma_series", "ss_group_pass",
                           "ss_edge_scan"),
              "gaussian_dense": (),
              "sbm": ("pg_devroye", "group_gram", "ss_edge_scan"),
              "gaussian_sparse": ("ss_group_pass", "ss_edge_scan")}


def geweke_lane(name, n_iters):
    """One Geweke lane of n_iters iterations on the card (run in a process
    of its own): the series, the launch counts, the loop that ran and the
    seconds."""
    import torch
    from pyglm_tpu_torch.diagnostics.geweke import geweke_chain
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.networks import (
        ErdosRenyiConfig, make_network)
    from pyglm_tpu_torch.models.observations import make_observation
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.basis import cosine_basis
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    lane = GW_LANES[name]
    weights.LAST_SS_PATH = None
    obs = make_observation(lane["obs"][0], **lane["obs"][1])
    n, b, l, t = (lane.get(k, v) for k, v in
                  (("N", GW_N), ("B", B), ("L", L), ("T", GW_T)))
    if "network" in lane:
        net = make_network(lane["network"], n, b, **lane["net"])
    else:
        net = ErdosRenyiConfig(N=n, B=b, learn_rho=False,
                               learn_weight_prior=False, **lane["net"])
    _build.library()
    _build.reset_launches()
    t0 = time.perf_counter()
    series = geweke_chain(lane["seed"], obs, net, n, b, cosine_basis(b, l),
                          t, spike_slab=lane.get("spike_slab", True),
                          n_iters=n_iters,
                          precision=lane["precision"],
                          with_llc=lane.get("llc", False), device="cuda")
    torch.cuda.synchronize()
    return (series, dict(_build.LAUNCHES), weights.LAST_SS_PATH,
            time.perf_counter() - t0)


def time_generation():
    """The per-bin generation loop alone at the Geweke shape: it paces every
    Geweke iteration."""
    import torch
    from pyglm_tpu_torch.models.ensemble import chain_generators
    from pyglm_tpu_torch.models.observations import Bernoulli
    from pyglm_tpu_torch.models.sweep import (
        init_state_from_prior, make_generator,
    )
    from pyglm_tpu_torch.models.networks import ErdosRenyiConfig
    from pyglm_tpu_torch.ops.basis import cosine_basis

    net = ErdosRenyiConfig(N=GW_N, B=B, learn_rho=False,
                           learn_weight_prior=False,
                           **GW_LANES["bernoulli_high"]["net"])
    dev = torch.device("cuda")
    gens = chain_generators(0, dev)
    st = init_state_from_prior(gens, Bernoulli(), net, GW_N, B, True, dev)
    gen = make_generator(Bernoulli(), GW_N, B)
    basis = cosine_basis(B, L)
    gen(gens.device, st, basis, GW_T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        gen(gens.device, st, basis, GW_T)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"geweke: generating {GW_T} bins takes {gen_ms:.1f} ms "
          f"({gen_ms / GW_T * 1e3:.0f} us a bin) alone", flush=True)
    return {"geweke_gen_ms_per_iter": gen_ms}


def start_geweke(ctx):
    """Start the Geweke lanes, one spawned process each; ctx["geweke"]
    holds the pending result. No timed phase follows them."""
    import multiprocessing as mp
    iters = {name: lane.get("iters", GW_ITERS)
             for name, lane in GW_LANES.items()}
    print(f"geweke: N={GW_N}, B={B}, T={GW_T}, {GW_BURN} burn-in, "
          f"iterations per lane {iters}, one process each", flush=True)
    pool = mp.get_context("spawn").Pool(len(GW_LANES))
    ctx["geweke_pool"] = pool
    ctx["geweke"] = pool.starmap_async(
        geweke_lane, list(iters.items()))
    ctx["geweke_t0"] = time.perf_counter()
    pool.close()


def phase_geweke(check, ctx):
    """Wait for the Geweke lanes and hold each to the prior."""
    from pyglm_tpu_torch.diagnostics.geweke import prior_gates
    res = dict(zip(GW_LANES, ctx["geweke"].get(timeout=3000)))
    dt = time.perf_counter() - ctx["geweke_t0"]
    ctx.pop("geweke_pool").join()
    print(f"geweke: {len(res)} lanes done {dt:.1f} s after their start",
          flush=True)
    for name, (series, launches, path, secs) in res.items():
        ran = {k: launches[k] for k in GW_KERNELS[name]}
        lane = GW_LANES[name]
        n_iters = lane.get("iters", GW_ITERS)
        print(f"  {name}: {n_iters} iterations {secs:.1f} s "
              f"({secs / n_iters * 1e3:.1f} ms an iteration), loop {path}, "
              f"launches {ran}")
        if lane.get("spike_slab", True):
            want = lane.get("path", "fused")
            check(path == want
                  and all(v >= n_iters for v in ran.values()),
                  f"{name}: the {want} loop ran and each of {list(ran)} "
                  f"launched at least once per iteration")
        else:
            check(path is None and sum(launches.values()) == 0,
                  f"{name}: the dense sweep ran (no spike-and-slab loop; the "
                  f"Gaussian family draws no PG, so no kernel launches)")
        obs = lane["obs"][1]
        net = lane["net"]
        gates = prior_gates(
            series, net, lane.get("B", B), GW_BURN, GW_Z,
            weights=name.startswith("bernoulli"),
            r_prior=(obs["a_r"], obs["b_r"]) if "a_r" in obs else None,
            max_y=obs.get("max_y"),
            eta_prior=(obs["a_eta"], obs["b_eta"]) if "a_eta" in obs
            else None,
            sbm_prior=(net["a_rho"], net["b_rho"]) if name == "sbm"
            else None)
        for what, ok, numbers in gates:
            print(f"    {what}: {numbers}")
            check(ok, f"{name}: the {what} marginal matches the prior")
    return {"geweke_s": dt}


# Config 5 in phase_acceptance: (burn-in, averaged) stacked sweeps.
ACC_C5_SWEEPS = (20, 20)


def phase_acceptance(check, record, ctx):
    """Acceptance configs 1 to 4 through the port's acceptance runner
    (pyglm_tpu_torch/acceptance.py) at full length, gated by its floors:
    config 1 (dense) at "high" and config 4 (SBM) at "high", "default" and
    "sr" on the data their truths generated in phase_dense and phase_sbm,
    config 2 at "high", config 3 at "high", "default" and "sr" on one
    simulated dataset (their loop is fused, so the modes differ). Then
    config 5 cut to ACC_C5_SWEEPS, ungated except for finite values and
    complete fields. Launch counts are read around each fit."""
    import math
    import numpy as np
    from pyglm_tpu_torch import acceptance as acc
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build

    gated, summary = [], {}
    grams = {"high": "ss_group_pass", "default": "ss_group_pass_bf16",
             "sr": "ss_group_pass_sr"}

    def fit(name, prec, want, path, **kw):
        _build.reset_launches()
        weights.LAST_SS_PATH = None
        t0 = time.perf_counter()
        res = acc.run(name, False, prec, "cuda", **kw)
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        for k in KERNELS:
            record[k]["launches"] += launches[k]
        ran = {k: launches[k] for k in want}
        print(f"  {res['config']} at {prec!r}: {dt:.1f} s, loop "
              f"{weights.LAST_SS_PATH}, launches {ran}\n    "
              + json.dumps(res), flush=True)
        summary[f"acc_{res['config']}_{prec}_s"] = dt
        if "truth_runaway" not in res:
            check(weights.LAST_SS_PATH == path and all(ran.values()),
                  f"{res['config']} at {prec!r}: the {path} loop ran, "
                  f"{list(ran)} launched")
        return res

    print("acceptance: configs 1 to 4 at full length, config 5 cut to "
          f"{ACC_C5_SWEEPS}", flush=True)
    true1, Y1 = ctx["c1"]
    gated.append(fit("1_bernoulli_dense", "high", ("pg_devroye",), None,
                     true=true1, Y=Y1))
    true4, Y4 = ctx["c4"]
    for prec in ("high", "default", "sr"):
        gated.append(fit("4_sbm", prec,
                         ("pg_devroye", grams[prec], "ss_edge_scan"),
                         "fused", true=true4, Y=Y4))
    c2 = fit("2_negative_binomial", "high",
             ("pg_gamma_series", "ss_group_pass", "ss_edge_scan"), "fused")
    if "truth_runaway" in c2:
        # The port's truth at the JAX script's seed is supercritical (its
        # counts reach the generator's cap), so no recovery can be scored.
        # The runner refuses to fit it and its report fails the gate; this
        # is recorded in ROADMAP.md Queue C. Checked here: that the refusal
        # is for that reason and no other.
        run_away = c2["truth_runaway"]
        check(run_away["max_count"] > 1e5,
              f"config 2: truth supercritical (max count "
              f"{run_away['max_count']:.0f} from bin "
              f"{run_away['first_bin_over_max_y']}), not fit; recorded, "
              f"not gated")
        summary["acc_c2_truth_runaway"] = run_away
    else:
        gated.append(c2)
    true = acc.make_truth("3_spike_slab", "cuda")
    T3 = acc.lengths("3_spike_slab", False)[0]
    Y3, gen_s = acc.simulate(true, T3 + T3 // 10)
    print(f"  config 3 truth: generate {T3 + T3 // 10} bins in {gen_s:.2f} s")
    for prec in ("high", "default", "sr"):
        gated.append(fit("3_spike_slab", prec,
                         ("pg_devroye", grams[prec], "ss_edge_scan"),
                         "fused", true=true, Y=Y3))
    passed, failures = acc.check_gates(gated)
    names = [r["config"] + " " + r["precision"] for r in gated]
    check(passed, f"{names} at or above the floors{failures or ''}")
    c5 = fit("5_latent_distance", "high",
             ("pg_devroye", "group_gram", "ss_edge_scan"), "staged",
             sweeps=ACC_C5_SWEEPS)
    fields = ("link_auc", "weight_corr", "pred_ll_gap_per_bin", "rhat_ll",
              "chain_link_auc_min", "chain_link_auc_max",
              "chain_link_auc_std", "chain_sweeps_per_sec")
    check(all(k in c5 and math.isfinite(c5[k]) for k in fields)
          and len(c5["chain_link_auc"]) == 8
          and np.isfinite(c5["chain_link_auc"]).all(),
          "config 5 (cut): every field present and finite")
    summary["acc_gate_failures"] = failures
    return summary


def phase_nb_slice(check, record, ctx):
    """The NB flagship (benchmarks/common.py) through the user entry points,
    and the launch counts of that run; then one dispersion update without
    the count table, which runs K5. The counts are kept in ctx["nb_Y"]."""
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
    ctx["nb_Y"] = Y
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
    check(launches["crt_sample_sums"] == 1
          and sum(launches.values()) == 1,
          "K5's sums form launched exactly once")
    check(bool(torch.isfinite(r2).all() and (r2 > 0).all()),
          "r from the elementwise CRT sums finite and positive")
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
                                device="cpu", aux=s["aux"],
                                network=mh.network)
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
        PAIR_TILE, TF32_PAIR_TILE, group_gram_blocks_cuda,
        group_gram_blocks_plain, tf32_split, wgmma_probe, wgmma_tf32_probe)
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
    # The "high" body's: A from registers (its split in registers), B as
    # Z_hi and Z_lo tiles. Values +-{1, 2, 3} + {-1, 0, 1} 2^-12 split
    # into an integer hi and a lo of 2^-12, so every sum is exact and the
    # product must equal the 3xTF32 product of the splits (lo lo dropped).
    def tf32_tile(shape):
        ints = torch.randint(1, 4, shape, generator=gen, device=dev) * (
            2 * torch.randint(0, 2, shape, generator=gen, device=dev) - 1)
        frac = torch.randint(-1, 2, shape, generator=gen, device=dev)
        return (ints + frac * 2.0 ** -12).float().contiguous()
    at, bt = tf32_tile((32, 64)), tf32_tile((TF32_PAIR_TILE, 32))
    (ah, al), (bh, bl) = tf32_split(at), tf32_split(bt)
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    want = al.T @ bh.T + ah.T @ bl.T + ah.T @ bh.T
    check(bool(al.abs().max() > 0) and torch.equal(
        wgmma_tf32_probe(at, bt).double(), want),
          f"wgmma TF32 probe (m64n{TF32_PAIR_TILE}k8, A from registers "
          "split in TF32 hi and lo, B as K-major Z_hi and Z_lo, 128-byte "
          "swizzle) equals the 3xTF32 product of the splits")
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
    regs = kernel_regs("group_gram_tf32_kernel") or {}
    record["group_gram"].update(
        max_abs_err=max_abs["high"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, precision="high", highest_ms=ms_fp32,
        highest_bound_ms=fp32["bound_ms"], f64_rel_err=f64["high"],
        highest_f64_rel_err=f64["highest"],
        plain_f64_rel_err=f64_plain["high"],
        registers=regs.get("registers"), spill_bytes=regs.get("spill_bytes"),
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
          f"{flops / ms_bf16 / 1e9:.1f} at default; the high body "
          f"{regs.get('registers')} registers, {regs.get('spill_bytes')} B "
          f"spilled")
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
        states_c.append(state_from_numpy(x["A"], x["W"], x["b"], x["net"],
                                         network=mc.network))
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

# Parallel tempering at acceptance config 5's width (benchmarks/
# config5_pt.py: N=500, T=20k, 8 rungs, "high"): the ladder from a pilot of
# TP_PILOT + TP_PILOT sweeps, then TP_TIMED timed tempered sweeps and a
# profiled run of TP_PROF. Each tempered sweep launches K4 once (PG(beta,
# psi) over all 8 x 500 lanes), K6 once and K3 once per group (the staged
# loop at 4000 lanes).
TP_RUNGS, TP_PILOT, TP_TIMED, TP_PROF = 8, 20, 10, 2
# K4 held to pg_mean / pg_var per rung at the tempered shape: |z| < TP_Z.
TP_Z = 6.0
# The cold rungs of PAR_C ladders (diagnostics/parity.py::tempered_pool) on
# seeds of their own.
TP_PAR_SEED0 = 501


def _k4_tempered(check, b, psi, gen, label):
    """K4 and its plain version at the tempered shape (T, C N) with b the
    betas tiled over each rung's lanes: every draw finite and positive, and
    per rung the sum's and the spread's z against pg_mean / pg_var (the
    spread's standard error from the draws' own fourth moment), |z| < TP_Z,
    and a two-sample KS test of kernel against plain on the rung's first
    200k draws. Returns the largest |z|."""
    import torch
    from scipy.stats import ks_2samp
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
    from pyglm_tpu_torch.ops.polyagamma import (
        pg_gamma_series_plain, pg_mean, pg_var)

    draws = {"K4": pg_gamma_series_cuda(b, psi, 71, 0, normal_cutoff=170.0),
             "plain": pg_gamma_series_plain(b, psi, gen, 170.0)}
    torch.cuda.synchronize()
    lanes = b.shape[1] // TP_RUNGS
    worst, zs, ks_min = 0.0, [], 1.0
    for name, om in draws.items():
        check(bool(torch.isfinite(om).all() and (om > 0).all()),
              f"{label}: {name} draws finite and positive")
    for c in range(TP_RUNGS):
        sl = slice(c * lanes, (c + 1) * lanes)
        m = pg_mean(b[:, sl], psi[:, sl]).double()
        v = pg_var(b[:, sl], psi[:, sl]).double()
        row = []
        for name, om in draws.items():
            x = om[:, sl].double()
            d2 = (x - m) ** 2
            z_m = float((x.sum() - m.sum()) / v.sum().sqrt())
            z_v = float((d2.sum() - v.sum()) / ((d2 - v) ** 2).sum().sqrt())
            row += [round(z_m, 2), round(z_v, 2)]
            worst = max(worst, abs(z_m), abs(z_v))
        ks = ks_2samp(draws["K4"][:, sl].flatten()[:200_000].cpu().numpy(),
                      draws["plain"][:, sl].flatten()[:200_000].cpu().numpy())
        ks_min = min(ks_min, ks.pvalue)
        zs.append((round(float(b[0, c * lanes]), 4), row,
                   round(float(ks.pvalue), 4)))
    print(f"  {label}: per rung (b, [z mean, z var] K4 then plain, KS p): "
          f"{zs}")
    check(worst < TP_Z, f"{label}: K4 and plain within {TP_Z:g} standard "
          f"errors of pg_mean and pg_var on every rung (max |z| "
          f"{worst:.2f})")
    check(ks_min > KS_P_MIN, f"{label}: K4 vs plain KS p > {KS_P_MIN} on "
          f"every rung (min {ks_min:.4f})")
    return worst


def phase_tempered_config5(check, record, ctx):
    """fit_tempered on config 5's model (phase_config5's, on its data): the
    pilot's sd(ll) and ladder, TP_TIMED timed tempered sweeps (chain-sweeps
    per second on the host clock), the device busy time of a profiled run,
    the launches per tempered sweep; then K4 at the tempered shape against
    its plain version in law, at the run's ladder and at the widest ladder
    suggest_ladder gives (its floor, beta = 0.05), timed and bounded."""
    import warnings
    import numpy as np
    import torch
    from pyglm_tpu_torch.diagnostics.timing import device_ms
    from pyglm_tpu_torch.models import tempering, weights
    from pyglm_tpu_torch.models.ensemble import lane_inputs, unstack_states
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
    from pyglm_tpu_torch.ops.polyagamma import pg_gamma_series_plain

    model = ctx["model"]
    n_groups = N5 // model.group
    print(f"tempered config 5: fit_tempered, {TP_RUNGS} rungs x {N5} lanes, "
          f"T={T5}, precision={model.precision!r}; pilot {TP_PILOT} + "
          f"{TP_PILOT} sweeps", flush=True)

    def run(**kw):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as warns:
            warnings.simplefilter("always")
            out = model.fit_tempered(n_rungs=TP_RUNGS, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        _add_launches(record, launches)
        for w in warns:
            print(f"  warning: {str(w.message)[:160]}")
        ok = (np.isfinite(out["lls"]).all() and np.isfinite(out["A"]).all()
              and np.isfinite(out["W"]).all()
              and np.isfinite(out["bias"]).all())
        rates = out["swap_rate"]
        check(bool(ok) and out["A"].shape[1:] == (N5, N5),
              "tempered outputs finite, shapes right")
        check(bool(np.all((rates >= 0) & (rates <= 1))),
              f"swap rates in [0, 1]: {np.round(rates, 3).tolist()}")
        return out, dt, launches

    out, pilot_s, _ = run(n_samples=2, pilot_sweeps=TP_PILOT)
    betas, sd_ll = out["betas"], out["sd_ll"]
    print(f"  pilot and 2 tempered sweeps: {pilot_s:.2f} s; sd(ll) "
          f"{sd_ll:.2f}; betas {np.round(betas, 5).tolist()}; span "
          f"{out['ladder_span']:.5f}")
    check(math.isfinite(sd_ll) and sd_ll > 0 and betas[-1] == 1.0,
          "pilot: sd(ll) finite, ladder ends at 1")

    out, dt, launches = run(n_samples=TP_TIMED, betas=betas)
    cs = TP_RUNGS * TP_TIMED / dt
    print(f"  {TP_TIMED} tempered sweeps in {dt:.3f} s = "
          f"{TP_TIMED / dt:.4f} sweeps/s = {cs:.3f} chain-sweeps/s; swap "
          f"rate {np.round(out['swap_rate'], 3).tolist()}; cold lls "
          f"{[round(float(x), 1) for x in out['lls'][-3:]]}; launches "
          f"{launches}")
    check(weights.LAST_SS_PATH == "staged",
          f"the tempered sweep ran the staged loop ({weights.LAST_SS_PATH})")
    check(launches["pg_gamma_series"] == TP_TIMED,
          f"K4 launched once per tempered sweep "
          f"({launches['pg_gamma_series']} for {TP_TIMED})")
    check(launches["group_gram"] == TP_TIMED,
          f"K6 launched once per tempered sweep ({launches['group_gram']})")
    check(launches["ss_edge_scan"] == TP_TIMED * n_groups,
          f"K3 launched {n_groups} times per tempered sweep "
          f"({launches['ss_edge_scan']})")
    check(launches["pg_devroye"] == 0 and launches["ss_group_pass"] == 0,
          "K1 and K2 not launched by the tempered sweep")

    kern = device_ms(lambda: model.fit_tempered(
        n_samples=TP_PROF, betas=betas, n_rungs=TP_RUNGS), 1)
    busy = sum(kern.values()) / TP_PROF
    wall = 1e3 * dt / TP_TIMED
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    print(f"  device busy {busy:.2f} ms per tempered sweep of {wall:.2f} ms "
          f"(host clock): idle share {1 - busy / wall:.3f}; top kernels "
          + "; ".join(f"{k[:40]} {v / TP_PROF:.2f}" for k, v in top))

    # K4 at the tempered shape, psi of the rungs' prior draws.
    st = tempering.init_tempered_states(model, betas)
    w, _ = lane_inputs(model.network, unstack_states(st, TP_RUNGS))
    psi = (model.datas[0].Xf @ w).contiguous()
    del st, w
    gen = torch.Generator(device="cuda").manual_seed(72)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the clamp, asked for here
        floor, _ = tempering.suggest_ladder(1e-3, TP_RUNGS)
    res = {}
    for label, lad in (("run ladder", betas), ("floor ladder", floor)):
        b = torch.tensor(np.repeat(lad, N5), dtype=torch.float32,
                         device="cuda")[None].expand(T5, -1).contiguous()
        zmax = _k4_tempered(check, b, psi, gen, f"K4 {label}")
        ms = event_ms(lambda: pg_gamma_series_cuda(
            b, psi, 3, 0, normal_cutoff=170.0), 10)
        res[label] = dict(ms=ms, max_z=zmax, betas=[float(x) for x in lad])
        print(f"  K4 at ({T5}, {TP_RUNGS * N5}), {label}: {ms:.3f} ms",
              flush=True)
    # The run ladder's K4 against its plain version and its bound: b and
    # psi in, omega out, and the special-function work the law needs.
    b = torch.tensor(np.repeat(betas, N5), dtype=torch.float32,
                     device="cuda")[None].expand(T5, -1).contiguous()
    plain_ms = event_ms(lambda: pg_gamma_series_plain(b, psi, gen, 170.0), 2)
    (law_ops, _), rate = k4_sfu_ops(b, psi, 170.0), sfu_rate()
    kb = bound(3 * 4 * b.numel(), (law_ops, rate))
    print(f"  run ladder: plain {plain_ms:.3f} ms, bound "
          f"{kb['bound_ms']:.4f} ms ({kb['bound_by']})")
    res["run ladder"].update(plain_ms=plain_ms, **kb)
    record["pg_gamma_series"].update(
        tempered_shape=[T5, TP_RUNGS * N5],
        tempered_ms=res["run ladder"]["ms"], tempered_plain_ms=plain_ms,
        tempered_bound_ms=kb["bound_ms"], tempered_bound_by=kb["bound_by"],
        tempered_floor_ms=res["floor ladder"]["ms"],
        tempered_max_z=max(v["max_z"] for v in res.values()))
    return {"tp_sd_ll": sd_ll, "tp_betas": [float(x) for x in betas],
            "tp_span": out["ladder_span"], "tp_pilot_s": pilot_s,
            "tp_sweeps_per_s": TP_TIMED / dt, "tp_chain_sweeps_per_s": cs,
            "tp_busy_ms": busy, "tp_wall_ms": wall,
            "tp_idle_share": 1 - busy / wall,
            "tp_swap_rate": [float(x) for x in out["swap_rate"]],
            "tp_k4": res}


def phase_tempered_parity(check, ctx):
    """The cold rungs of PAR_C ladders of parity.TEMPER_BETAS, run as one
    tempered pass of PAR_C x 4 rungs on the chain-parity data; the pool is
    added to ctx["par_pools"], so that phase_oracle_parity holds it to the
    oracle's chains with the gates of the other pools."""
    import numpy as np
    from pyglm_tpu_torch.diagnostics import parity as par

    C = len(par.TEMPER_BETAS)
    print(f"tempered parity: {par.PAR_C} ladders of {par.TEMPER_BETAS} as "
          f"one pass of {par.PAR_C * C} rungs, {par.PAR_BURN} + "
          f"{par.PAR_KEEP} sweeps", flush=True)
    t0 = time.perf_counter()
    pool, rates, path = par.tempered_pool(ctx["par_Y"], TP_PAR_SEED0)
    dt = time.perf_counter() - t0
    r = par.pool_compare(pool, ctx["par_pools"]["high"])
    print(f"  {dt:.1f} s; loop {path}; swap rates "
          f"{np.round(rates, 3).tolist()}; against the 'high' pool: "
          + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
    check(bool(np.all((rates >= 0) & (rates <= 1)) and rates.min() > 0.05),
          "every rung swaps, rates in [0, 1]")
    check(all(np.isfinite(v).all() for v in pool.values()),
          "cold-rung means finite")
    ctx["par_pools"]["tempered_cold"] = pool
    return {"tempered_parity_s": dt,
            "tempered_parity_swap_rate": [float(x) for x in rates]}


def phase_regressions(check, record, ctx):
    """The standalone regressions at a size users would call real: the NB
    regression of the NB flagship's counts (T = 1e5, D_out = 200) on the
    previous bin's counts (D_in = 200), REG_RESAMPLES resamples (K4 and K5
    each once a resample); the Bernoulli regression of whether each neuron
    fired on the same covariates (K1); and pgdrawv at 2e7 draws, all-ones
    (K1) and b = y + 4 (K4), each held to pg_mean."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import (
        BernoulliRegression, NegativeBinomialRegression, PyPolyaGamma)
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var

    Yc = torch.as_tensor(ctx["nb_Y"], dtype=torch.float32, device="cuda")
    X, y = Yc[:-1], Yc[1:]
    prior = dict(sigmasq_A=0.01, mu_b=-2.0, seed=0, device="cuda")
    out = {}

    def window(label, fn, want):
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        _add_launches(record, launches)
        ran = {k: v for k, v in launches.items() if v}
        print(f"  {label}: {dt:.3f} s, launches {ran}", flush=True)
        check(ran == want, f"{label}: launches {want}")
        out[f"{label}_s"] = dt
        return res

    print(f"regressions: NB regression T={X.shape[0]}, D_in={N}, "
          f"D_out={N}; Bernoulli regression; pgdrawv at 2e7", flush=True)
    nb = NegativeBinomialRegression(N, N, max_y=16, **prior)

    def nb_fit():
        for _ in range(REG_RESAMPLES):
            nb.resample((X, y))
        return nb.log_likelihood((X, y))
    ll = window("nb_regression", nb_fit,
                {"pg_gamma_series": REG_RESAMPLES,
                 "crt_sample_sums": REG_RESAMPLES})
    print(f"    r mean {nb.r.mean():.4f} range [{nb.r.min():.4f}, "
          f"{nb.r.max():.4f}]; sum log-likelihood {ll.sum():.1f}")
    check(np.isfinite(nb.A).all() and np.isfinite(nb.b).all()
          and np.all(nb.r >= 1e-3) and np.isfinite(ll).all(),
          "NB regression: A, b, r and log-likelihood finite")

    br = BernoulliRegression(N, N, **prior)
    yb = (y > 0).to(torch.float32)

    def b_fit():
        for _ in range(2):
            br.resample((X, yb))
        return br.log_likelihood((X, yb))
    ll = window("bernoulli_regression", b_fit, {"pg_devroye": 2})
    check(np.isfinite(br.A).all() and np.isfinite(ll).all(),
          "Bernoulli regression: A and log-likelihood finite")

    n = 20_000_000
    gen = torch.Generator(device="cuda").manual_seed(9)
    zs = (2.0 * torch.randn(n, generator=gen, device="cuda")).cpu().numpy()
    for label, ns, want in (
            ("pgdrawv_ones", np.ones(n, np.float32), {"pg_devroye": 1}),
            ("pgdrawv_counts", Yc.flatten().cpu().numpy() + 4.0,
             {"pg_gamma_series": 1})):
        ppg = PyPolyaGamma(3, device="cuda")
        res = window(label, lambda: ppg.pgdrawv(ns, zs), want)
        bt, ct = torch.as_tensor(ns), torch.as_tensor(zs)
        z = float((torch.as_tensor(res).double().sum()
                   - pg_mean(bt, ct).double().sum())
                  / pg_var(bt, ct).double().sum().sqrt())
        check(res.shape == (n,) and np.isfinite(res).all()
              and (res > 0).all() and abs(z) < 6.0,
              f"{label}: {n} draws finite, positive, sum within 6 standard "
              f"errors of pg_mean (z {z:.2f})")
    return {"reg": out}


def phase_checkpoint(check, record, ctx):
    """Exact resume on the card at the flagship at "high": 2 sweeps, save,
    CK_SWEEPS more; a model of another seed loads the file and runs
    CK_SWEEPS: A, W and b torch.equal to the first run's."""
    import tempfile
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.utils.checkpoint import load_state, save_state

    print(f"checkpoint: the flagship at 'high', 2 + {CK_SWEEPS} sweeps, "
          f"resume for {CK_SWEEPS}", flush=True)
    models = [SparseBernoulliGLM(N, B=B, L=L, seed=s, precision="high",
                                 device="cuda") for s in (0, 1)]
    for m in models:
        m.add_data(ctx["flagship_Y"])
    a, r = models
    _build.reset_launches()
    for _ in range(2):
        a.resample_model()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "chain.npz")
        save_state(path, a)
        for _ in range(CK_SWEEPS):
            a.resample_model()
        load_state(path, r)
    for _ in range(CK_SWEEPS):
        r.resample_model()
    torch.cuda.synchronize()
    _add_launches(record, dict(_build.LAUNCHES))
    same = {f: torch.equal(getattr(a.state, f), getattr(r.state, f))
            for f in ("A", "W", "b")}
    diff = {f: float((getattr(a.state, f) - getattr(r.state, f)).abs().max())
            for f in same}
    print(f"  resumed chain equal to the first: {same} (max |diff| {diff})")
    check(all(same.values()), "resume from a checkpoint is bit-identical")
    return {"checkpoint_equal": all(same.values())}


# The mesh phases (parallel/sharding.py): SPMD ranks spawned on cuda:0 under
# gloo (NCCL refuses two ranks on one card; gloo's collectives go through
# the host), and one NCCL rank. Times of ranks that share one card are not
# multi-GPU rates. The flagship update on each data mesh is held to the
# unsharded update on the same omega and noise. On (1, 2), with no time
# split, a rank's update does the unsharded update's work on its 100
# lanes: A and w identical to the unsharded update run on those lanes
# alone (K2 splits T by the lane count, so 100 lanes sum in another order
# than all 200). On (2, 1), whose time ranks add their Grams in another
# order, the differing edges and w are held to 10x the update's own
# sensitivity to fp32 order (phase_staged_vs_fused's measure: the fused
# loop on psi from a float64 product).
MESH_SHAPES = ((2, 1), (1, 2))
MESH_SWEEPS = 5
# NB's r update on a mesh against the unsharded update on the same inputs
# and generator state: the counts sum exactly, the rates over T = 100000
# in another fp32 order.
MESH_R_RTOL = 1e-5
MESH_C5_BURN, MESH_C5_KEEP = 1, 4
# A fixed ladder for the tempered chain mesh (no pilot): 8 rungs up to 1.
MESH_TP_BETAS = (0.93, 0.94, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0)
MESH_PAR_SEED0 = 601


def _mesh_update_case(model, mesh):
    """The flagship's spike-and-slab update on `mesh` against the
    unsharded update on the same omega (K1 on a seeded stream) and noise,
    and the unsharded update's own sensitivity to float32 order (the fused
    loop on psi from a float64 product): rank-local counts, summed by the
    parent over lane ranks. Without a time split, also whether A and w
    equal the unsharded update's on the rank's lanes alone. Shards
    `model` on `mesh` on the way."""
    import torch
    from pyglm_tpu_torch.models.weights import (
        SpikeSlabNoise, lane_hypers, pack_weights,
        resample_spike_slab_tspace)
    from pyglm_tpu_torch.ops.polyagamma import pg_draw_unit
    from pyglm_tpu_torch.parallel.sharding import glm_shardings, shard_model
    d, st = model.datas[0], model.state
    w = pack_weights(st.A, st.W, st.b)
    hyp = model.network.edge_hypers(st.net, "cuda")
    psi = d.Xf @ w
    omega = pg_draw_unit(psi, torch.Generator().manual_seed(78))
    kappa = d.Y - 0.5
    g = torch.Generator(device="cuda").manual_seed(77)
    ng = N // G
    noise = SpikeSlabNoise(
        torch.rand((ng, G, N), generator=g, device="cuda"),
        torch.randn((ng, G, N, B), generator=g, device="cuda"),
        torch.randn((N,), generator=g, device="cuda"))

    def update(**kw):
        return resample_spike_slab_tspace(None, d.Xt, omega, kappa,
                                          kw.pop("psi", psi), w, hyp, B,
                                          group=G, noise=noise,
                                          precision="high", **kw)[:2]
    A_u, w_u = update(path="fused")
    A_r, w_r = update(path="fused", psi=(d.Xf.double() @ w.double()).float())
    lay = glm_shardings(mesh, T, N)
    r, ln = lay.rows, lay.lanes
    shard_model(model, mesh)
    dl = model.datas[0]
    A_s, w_s = resample_spike_slab_tspace(
        None, dl.Xt, omega[r, ln].contiguous(), kappa[r, ln].contiguous(),
        psi[r, ln].contiguous(), w[:, ln], lane_hypers(hyp, ln), B,
        group=G, noise=noise, precision="high", mesh=mesh)[:2]
    block_equal = None
    if mesh.shape["time"] == 1:
        # the unsharded update on this rank's lanes alone
        A_b, w_b = resample_spike_slab_tspace(
            None, d.Xt, omega[:, ln].contiguous(), kappa[:, ln].contiguous(),
            psi[:, ln].contiguous(), w[:, ln], lane_hypers(hyp, ln), B,
            group=G, noise=SpikeSlabNoise(noise.u_a[..., ln],
                                          noise.eps[:, :, ln],
                                          noise.bias[ln]),
            precision="high", path="fused")[:2]
        block_equal = bool(torch.equal(A_s, A_b) and torch.equal(w_s, w_b))

    def diff(A1, w1, A2, w2):
        """Edges that differ, and max |w1 - w2| on the lanes whose edges
        all agree."""
        same = ~(A1 != A2).any(0)
        return int((A1 != A2).sum()), float((w1 - w2)[:, same].abs().max())
    out = {"n_active": int(A_u[:, ln].sum()),
           "w_max": float(w_u[:, ln].abs().max()),
           "block_equal": block_equal}
    for k, pair in (("diff", (A_s, w_s, A_u[:, ln], w_u[:, ln])),
                    ("psi", (A_r[:, ln], w_r[:, ln], A_u[:, ln],
                             w_u[:, ln]))):
        out[f"n_{k}"], out[f"w_{k}"] = diff(*pair)
    return out


def _mesh_nb(Y):
    """The NB flagship on a (2, 1) mesh: one sharded sweep (K4 on the
    rank's tile; the r update reads the time-summed count table), then the
    r update without the table (K5 on the rank's tile, the CRT sums summed
    over "time" and the draw at full width) and with it, each against the
    unsharded update on the whole Y and psi with the replicated generator
    in the same state. Without the table the unsharded update is fed the
    mesh's own CRT sums: each rank's tile drawn again from its shard
    generator's state by K5's sums form, summed over "time" and
    gathered."""
    import torch
    from pyglm_tpu_torch import SparseNegativeBinomialGLM, make_mesh
    from pyglm_tpu_torch.models import observations as O
    from pyglm_tpu_torch.models.weights import pack_weights
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.parallel.sharding import (
        all_gather, gather_tile, lane_shard)
    mesh = make_mesh(2, 1)
    model = SparseNegativeBinomialGLM(N, B=B, L=L, seed=0, obs_kwargs=NB_OBS,
                                      device="cuda")
    model.add_data(Y)
    model.shard(mesh)
    _build.reset_launches()
    ll = model.resample_model()["log_likelihood"]
    sweep = dict(_build.LAUNCHES)
    obs, d, st = model.observation, model.datas[0], model.state
    shard = lane_shard(mesh, N, model.generators.host)
    psi = d.Xf @ pack_weights(st.A, st.W, st.b)
    Yl = d.Y[:, shard.lanes].contiguous()
    rep_state = model.generators.host.get_state()
    crt_state = model.shard_generators.host.get_state()
    _build.reset_launches()
    r = obs.resample_aux(model.shard_generators.host, st.aux, Yl, psi,
                         cache=None, shard=shard)["r"]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    # the unsharded updates (their K5 draw and the table's re-draw are
    # comparison launches, after the counts were read)
    r_full = all_gather(st.aux["r"], mesh, "neuron")
    Y_full, psi_full = gather_tile(Yl, mesh), gather_tile(psi, mesh)
    s_full = shard.full(O.crt_sample_sums(
        Yl, st.aux["r"], obs.max_y,
        torch.Generator().set_state(crt_state)))
    saved, O.crt_sample_sums = O.crt_sample_sums, lambda *a: s_full
    try:
        r_u = obs.resample_aux(torch.Generator().set_state(rep_state),
                               {"r": r_full}, Y_full, psi_full)["r"]
    finally:
        O.crt_sample_sums = saved
    shard.generator.set_state(rep_state)
    r_t = obs.resample_aux(None, st.aux, Yl, psi, cache=d.llc,
                           shard=shard)["r"]
    r_tu = obs.resample_aux(torch.Generator().set_state(rep_state),
                            {"r": r_full}, Y_full, psi_full,
                            cache=obs.ll_cache(Y_full))["r"]
    ln = shard.lanes
    return {"ll": ll, "sweep": sweep, "r_update": launches,
            "r": r.cpu(),
            "r_rel": float((r / r_u[ln] - 1).abs().max()),
            "r_table_rel": float((r_t / r_tu[ln] - 1).abs().max())}


def mesh_rank(rank, world, paths):
    """One rank of the mesh phase (2 ranks on cuda:0, gloo): the flagship
    on each of MESH_SHAPES, then config 5's ensemble and its tempered
    ladder on a chain mesh of 2. Returns what the parent checks."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import (
        NonlinearAutoregressiveModel, SparseBernoulliGLM, make_chain_mesh,
        make_mesh)
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    Y = np.load(paths["flagship"])
    for shape in MESH_SHAPES:
        mesh = make_mesh(*shape)
        model = SparseBernoulliGLM(N, B=B, L=L, seed=0, device="cuda")
        model.add_data(Y)
        r = _mesh_update_case(model, mesh)
        model.resample_model()                       # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        lls = [model.resample_model()["log_likelihood"]
               for _ in range(MESH_SWEEPS)]
        torch.cuda.synchronize()
        r.update(sweep_s=(time.perf_counter() - t0) / MESH_SWEEPS, lls=lls,
                 launches=dict(_build.LAUNCHES), path=weights.LAST_SS_PATH,
                 collectives=dict(mesh.collectives))
        out[shape] = r
        del model
        torch.cuda.empty_cache()
    out["nb"] = _mesh_nb(np.load(paths["nb"]))
    mesh = make_chain_mesh(2)
    Y5 = np.load(paths["c5"])
    kw = dict(B=B, L=L, observation="bernoulli", network="latent_distance",
              spike_and_slab=True, device="cuda", precision="high",
              net_kwargs=dict(dim=2))
    model = NonlinearAutoregressiveModel(N5, seed=0, **kw)
    model.add_data(Y5)
    _build.reset_launches()
    t0 = time.perf_counter()
    ens = model.fit_ensemble(n_chains=C5, n_burnin=MESH_C5_BURN,
                             n_samples=MESH_C5_KEEP, mesh=mesh,
                             collect="mean")
    torch.cuda.synchronize()
    out["c5"] = {"s": time.perf_counter() - t0, "lls": ens["lls"],
                 "rhat_ll": ens["rhat_ll"], "path": weights.LAST_SS_PATH,
                 "launches": dict(_build.LAUNCHES), "group": model.group}
    _build.reset_launches()
    t0 = time.perf_counter()
    tp = model.fit_tempered(n_samples=MESH_SWEEPS,
                            betas=np.asarray(MESH_TP_BETAS), mesh=mesh)
    torch.cuda.synchronize()
    out["tempered"] = {"s": time.perf_counter() - t0, "lls": tp["lls"],
                       "swap_rate": tp["swap_rate"],
                       "launches": dict(_build.LAUNCHES),
                       "path": weights.LAST_SS_PATH}
    return out


def nccl_rank(rank, world, paths):
    """The flagship on a one-rank NCCL mesh: 2 sharded sweeps whose
    collectives go through NCCL."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM, make_mesh
    from pyglm_tpu_torch.models import weights
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, 1)
    model = SparseBernoulliGLM(N, B=B, L=L, seed=0, device="cuda")
    model.add_data(np.load(paths["flagship"]))
    model.shard(mesh)
    t0 = time.perf_counter()
    lls = [model.resample_model()["log_likelihood"] for _ in range(2)]
    torch.cuda.synchronize()
    return {"backend": mesh.backend, "collectives": dict(mesh.collectives),
            "lls": lls, "path": weights.LAST_SS_PATH,
            "s": time.perf_counter() - t0}


def parity_rank(rank, world, paths, s0):
    """One rank of the chain-data parity pool: PAR_C stacked chains through
    fit_ensemble(mesh=make_chain_data_mesh(2, n_time=2))."""
    import numpy as np
    import torch
    from pyglm_tpu_torch import make_chain_data_mesh
    from pyglm_tpu_torch.diagnostics import parity as par
    from pyglm_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_chain_data_mesh(2, n_time=2)
    t0 = time.perf_counter()
    pool, path = par.parity_pool(np.load(paths["par"]), "high", s0,
                                 device="cuda", mesh=mesh)
    return {"pool": pool, "path": path, "s": time.perf_counter() - t0,
            "launches": dict(_build.LAUNCHES),
            "collectives": dict(mesh.collectives)}


def _save_arrays(d, **arrays):
    """Each array as d/<name>.npy; returns {name: path}."""
    import numpy as np
    paths = {k: os.path.join(d, f"{k}.npy") for k in arrays}
    for k, v in arrays.items():
        np.save(paths[k], np.asarray(v))
    return paths


def phase_mesh(check, record, ctx):
    """The sharded port on the card: (a) the flagship on the data meshes
    (2, 1) and (1, 2), its update against the unsharded one and 5 timed
    sharded sweeps with each rank's launches, and the NB flagship on
    (2, 1): one sweep (K4), then its r update without its count table
    (K5) and with it, each against the unsharded update on the same
    inputs and generator state;
    (b) config 5's ensemble of 8 chains on a chain mesh of 2 (1 + 4
    sweeps, collect="mean"); (c) its tempered ladder of 8 rungs on that
    mesh (5 sweeps, a fixed ladder); (d) the flagship on a one-rank NCCL
    mesh. Ranks of (a)-(c) share cuda:0 under gloo; the data are the
    flagship's, the NB flagship's and config 5's of the earlier phases,
    passed as temporary .npy files."""
    import tempfile
    import numpy as np
    import torch
    from pyglm_tpu_torch.parallel.sharding import spawn

    print("mesh: 2 ranks on cuda:0 (gloo), then 1 rank (nccl)", flush=True)
    with tempfile.TemporaryDirectory(prefix="pyglm_mesh_") as d:
        paths = _save_arrays(d, flagship=ctx["flagship_Y"], c5=ctx["c5_Y"],
                             nb=ctx["nb_Y"])
        t0 = time.perf_counter()
        res = spawn(mesh_rank, 2, backend="gloo", device="cuda:0",
                    args=(paths,), timeout_s=600)
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = spawn(nccl_rank, 1, backend="nccl", device="cuda:0",
                     args=(paths,), timeout_s=300)[0]
        nccl_s = time.perf_counter() - t0
    ng = N // G
    for shape in MESH_SHAPES:
        rs = [r[shape] for r in res]
        lane_ranks = rs if shape[1] > 1 else rs[:1]
        n = {k: sum(r[k] for r in lane_ranks)
             for k in ("n_diff", "n_psi", "n_active")}
        w = {k: max(r[k] for r in rs)
             for k in ("w_diff", "w_psi", "w_max")}
        n_diff = n["n_diff"]
        print(f"  flagship on {shape}: sharded vs unsharded update: "
              f"{n_diff} edges differ (of {n['n_active']} active), w "
              f"{w['w_diff']:.2e} on the agreeing lanes (max |w| "
              f"{w['w_max']:.3f}); the update's own sensitivity to fp32 "
              f"order (psi from float64): {n['n_psi']} edges, w "
              f"{w['w_psi']:.2e}")
        if shape[0] == 1:
            check(all(r["block_equal"] for r in rs),
                  f"{shape}: A and w identical to the unsharded update on "
                  f"each rank's lanes alone")
        else:
            lim, w_lim = 10 * n["n_psi"], 10 * w["w_psi"]
            check(n_diff <= lim and w["w_diff"] <= w_lim,
                  f"{shape}: {n_diff} edges differ, limit {lim}; w "
                  f"{w['w_diff']:.2e}, limit {w_lim:.2e} (10x the fused "
                  f"update's own sensitivity to psi's fp32 order)")
        for i, r in enumerate(rs):
            L_ = r["launches"]
            print(f"    rank {i}: {MESH_SWEEPS} sweeps, "
                  f"{r['sweep_s'] * 1e3:.1f} ms a sweep (ranks share one "
                  f"card); launches {L_}; "
                  f"lls {[round(x, 1) for x in r['lls']]}; "
                  f"{r['collectives']['gloo']} gloo collectives")
            check(L_["pg_devroye"] == MESH_SWEEPS
                  and L_["ss_group_pass"] == (ng + 1) * MESH_SWEEPS
                  and L_["ss_edge_scan"] == ng * MESH_SWEEPS
                  and L_["group_gram"] == 0,
                  f"{shape} rank {i}: K1 1, K2 {ng + 1}, K3 {ng}, K6 0 a "
                  f"sweep")
            check(r["path"] == "mesh_fused", f"{shape} rank {i}: "
                  f"LAST_SS_PATH {r['path']!r} == 'mesh_fused'")
            check(all(math.isfinite(x) for x in r["lls"]),
                  f"{shape} rank {i}: lls finite")
            _add_launches(record, L_)
        check(all(r["lls"] == rs[0]["lls"] for r in rs),
              f"{shape}: every rank returns the same lls")
    for i, r in enumerate(res):
        nb = r["nb"]
        print(f"  NB flagship on (2, 1), rank {i}: ll {nb['ll']:.1f}; sweep "
              f"launches {nb['sweep']}; r update without the table: "
              f"launches {nb['r_update']}, mean r {float(nb['r'].mean()):.4f}"
              f"; against the unsharded update: max |r/r_u - 1| "
              f"{nb['r_rel']:.2e} (K5), {nb['r_table_rel']:.2e} (the table)")
        check(nb["sweep"]["pg_gamma_series"] == 1
              and nb["sweep"]["crt_sample_sums"] == 0
              and nb["r_update"]["crt_sample_sums"] == 1
              and sum(nb["r_update"].values()) == 1,
              f"NB on (2, 1) rank {i}: K4 once a sweep; K5 once in the r "
              f"update without the table")
        check(math.isfinite(nb["ll"]) and bool(torch.isfinite(nb["r"]).all()
                                               and (nb["r"] > 0).all())
              and torch.equal(nb["r"], res[0]["nb"]["r"]),
              f"NB on (2, 1) rank {i}: r finite, positive, the same on "
              f"every rank")
        check(nb["r_rel"] <= MESH_R_RTOL and nb["r_table_rel"] <= MESH_R_RTOL,
              f"NB on (2, 1) rank {i}: r without and with the table within "
              f"rtol {MESH_R_RTOL:g} of the unsharded update on the same "
              f"inputs and generator state")
        _add_launches(record, nb["sweep"])
        _add_launches(record, nb["r_update"])
    n_sw = MESH_C5_BURN + MESH_C5_KEEP
    for i, r in enumerate(res):
        c5, tp = r["c5"], r["tempered"]
        n5 = N5 // c5["group"]
        print(f"  config 5 on a chain mesh of 2, rank {i}: {n_sw} sweeps of "
              f"{C5 // 2} chains in {c5['s']:.2f} s (ranks share one card); "
              f"launches {c5['launches']}; rhat_ll {c5['rhat_ll']:.3f}")
        L_ = c5["launches"]
        check(c5["path"] == "staged" and L_["group_gram"] == n_sw
              and L_["pg_devroye"] == n_sw and L_["ss_group_pass"] == 0
              and L_["ss_edge_scan"] == n5 * n_sw,
              f"config 5 chain mesh rank {i}: the staged loop, K6 and K1 "
              f"once and K3 {n5} times a sweep")
        check(np.asarray(c5["lls"]).shape == (C5, MESH_C5_KEEP)
              and np.isfinite(c5["lls"]).all()
              and math.isfinite(c5["rhat_ll"]),
              f"config 5 chain mesh rank {i}: lls and rhat finite")
        _add_launches(record, L_)
        L_ = tp["launches"]
        print(f"  tempered config 5 on a chain mesh of 2, rank {i}: "
              f"{MESH_SWEEPS} sweeps in {tp['s']:.2f} s; swap rates "
              f"{np.round(tp['swap_rate'], 3).tolist()}; launches {L_}")
        check(L_["pg_gamma_series"] == MESH_SWEEPS
              and L_["group_gram"] == MESH_SWEEPS
              and L_["ss_edge_scan"] == n5 * MESH_SWEEPS,
              f"tempered chain mesh rank {i}: K4 and K6 once, K3 {n5} "
              f"times a sweep")
        check(bool(np.all((tp["swap_rate"] >= 0) & (tp["swap_rate"] <= 1)))
              and np.isfinite(tp["lls"]).all(),
              f"tempered chain mesh rank {i}: swap rates in [0, 1], the "
              f"cold rung's lls finite")
        _add_launches(record, L_)
    print(f"  nccl: backend {nccl['backend']}, 2 sharded sweeps in "
          f"{nccl['s']:.2f} s, {nccl['collectives']} collectives, lls "
          f"{[round(x, 1) for x in nccl['lls']]}, loop {nccl['path']}")
    check(nccl["backend"] == "nccl" and nccl["collectives"]["nccl"] > 0
          and nccl["collectives"]["gloo"] == 0
          and all(math.isfinite(x) for x in nccl["lls"])
          and nccl["path"] == "mesh_fused",
          "the one-rank NCCL mesh ran the sharded sweep through NCCL")
    return {"mesh_gloo_s": gloo_s, "mesh_nccl_s": nccl_s,
            "mesh_sweep_ms": {str(s): [r[s]["sweep_s"] * 1e3 for r in res]
                              for s in MESH_SHAPES}}


def phase_mesh_parity(check, ctx):
    """PAR_C chains on the chain-parity data through
    fit_ensemble(mesh=make_chain_data_mesh(2, n_time=2)) on 4 ranks
    (cuda:0, gloo); the pool is added to ctx["par_pools"], so that
    phase_oracle_parity holds it to the oracle's chains with the gates of
    the other pools."""
    import tempfile
    import numpy as np
    from pyglm_tpu_torch.diagnostics import parity as par
    from pyglm_tpu_torch.parallel.sharding import spawn
    print(f"mesh parity: {par.PAR_C} stacked chains on a chain-data mesh "
          f"2 x 2 x 1 (4 ranks on cuda:0, gloo), {par.PAR_BURN} + "
          f"{par.PAR_KEEP} sweeps", flush=True)
    with tempfile.TemporaryDirectory(prefix="pyglm_mesh_") as d:
        paths = _save_arrays(d, par=ctx["par_Y"])
        t0 = time.perf_counter()
        res = spawn(parity_rank, 4, backend="gloo", device="cuda:0",
                    args=(paths, MESH_PAR_SEED0), timeout_s=900)
        dt = time.perf_counter() - t0
    pool = res[0]["pool"]
    r = par.pool_compare(pool, ctx["par_pools"]["high"])
    print(f"  {dt:.1f} s; loop {res[0]['path']}; rank seconds "
          f"{[round(x['s'], 1) for x in res]}; against the 'high' pool: "
          + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))
    check(all(x["path"] == "mesh_fused" for x in res),
          "every rank ran the mesh-fused loop")
    check(all(all(np.array_equal(x["pool"][k], pool[k]) for k in pool)
              for x in res), "every rank returns the same pool")
    ctx["par_pools"]["chain_data_mesh"] = pool
    return {"mesh_parity_s": dt}


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
    t_run = time.perf_counter()
    # The timed phases first, alone on the card and the host. Then the
    # oracle's chains (host processes) and the Geweke lanes (processes of
    # their own on the card) run beside the untimed correctness phases.
    phases = (
        ("kernels", lambda: phase_kernels(check, record)),
        ("kernels_nb", lambda: phase_kernels_nb(check, record)),
        ("kernel_gram", lambda: phase_kernel_gram(check, record)),
        ("kernel_gram_flagship",
         lambda: phase_kernel_gram_flagship(check, record)),
        ("slice", lambda: summary.update(phase_slice(check, record, ctx))),
        ("highest",
         lambda: summary.update(phase_highest(check, record, ctx))),
        ("bf16_flagship_default", lambda: summary.update(
            phase_bf16_flagship(check, record, ctx, "default"))),
        ("bf16_flagship_sr", lambda: summary.update(
            phase_bf16_flagship(check, record, ctx, "sr"))),
        ("nb_slice",
         lambda: summary.update(phase_nb_slice(check, record, ctx))),
        ("config5", lambda: summary.update(phase_config5(check, record,
                                                         ctx))),
        ("config5_default", lambda: summary.update(phase_config5_default(
            check, record, ctx))),
        ("staged_vs_fused",
         lambda: summary.update(phase_staged_vs_fused(check, ctx))),
        ("dense", lambda: summary.update(phase_dense(check, record, ctx))),
        ("sbm", lambda: summary.update(phase_sbm(check, record, ctx))),
        ("gaussian", lambda: summary.update(phase_gaussian(check, record))),
        ("surface", lambda: phase_surface(check, record)),
        ("acceptance",
         lambda: summary.update(phase_acceptance(check, record, ctx))),
        ("generation", lambda: summary.update(time_generation())),
        ("tempered_config5", lambda: summary.update(
            phase_tempered_config5(check, record, ctx))),
        ("regressions",
         lambda: summary.update(phase_regressions(check, record, ctx))),
        ("checkpoint",
         lambda: summary.update(phase_checkpoint(check, record, ctx))),
        ("mesh", lambda: summary.update(phase_mesh(check, record, ctx))),
        ("native_oracle", lambda: phase_native_oracle(check)),
        ("oracle_start", lambda: start_oracle(ctx)),
        ("chain_parity",
         lambda: summary.update(phase_chain_parity(check, ctx))),
        ("tempered_parity",
         lambda: summary.update(phase_tempered_parity(check, ctx))),
        ("mesh_parity",
         lambda: summary.update(phase_mesh_parity(check, ctx))),
        ("geweke_start", lambda: start_geweke(ctx)),
        ("config_parity", lambda: phase_config_parity(check, ctx)),
        ("small_parity", lambda: phase_small_parity(check)),
        ("small_parity_nb", lambda: phase_small_parity(check, nb=True)),
        ("small_parity_default",
         lambda: phase_small_parity(check, precision="default")),
        ("small_parity_sr",
         lambda: phase_small_parity(check, precision="sr")),
        ("small_staged_parity", lambda: phase_small_staged_parity(check)),
        ("hmc_parity", lambda: phase_hmc_parity(check)),
        ("oracle_parity",
         lambda: summary.update(phase_oracle_parity(check, ctx))),
        ("geweke", lambda: summary.update(phase_geweke(check, ctx))))
    phase_s = {}
    try:
        for name, phase in phases:
            t0 = time.perf_counter()
            try:
                phase()
            except Exception:                  # recorded; the run fails
                traceback.print_exc()
                check(False, f"phase {name} raised")
            torch.cuda.empty_cache()
            phase_s[name] = round(time.perf_counter() - t0, 2)
            print(f"phase {name}: {phase_s[name]} s", flush=True)
    finally:
        for pool in ("oracle_pool", "cfg_oracle_pool", "geweke_pool"):
            if pool in ctx:                # a phase failed before the join
                ctx.pop(pool).terminate()
    total_s = time.perf_counter() - t_run
    print(f"phases: {phase_s}; total {total_s:.1f} s")
    summary.update(phase_s=phase_s, total_s=total_s)
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
