"""Device time of kernels K3 (the spike-and-slab edge scan,
``csrc/ss_edge_scan.cu``), K4 (gamma-series PG(b, c), ``csrc/pg_gamma.cu``)
and K5 (CRT counts, ``csrc/crt.cu``) at the main paths' shapes, for the
package of a given checkout.

    python pyglm_tpu_torch/diagnostics/time_k3_k4.py [ROOT] [--only k3|k4|k5]
        [--tiles 8,16,32] [--terms 1,2,8,16]
        [--cut rng|logs|setup|units|search|regs]...

ROOT (default: the checkout holding this file) is put first on sys.path, so
older checkouts' packages can be timed on the same card in one command, in
turns (older, this, this, older).

K3 at two shapes, with priors of a non-identity Lam0 and a nonzero mu0:
the flagship's group (G=8, B=4, 200 lanes; the packed Gram of 32 design
rows over T = 1e5, warm in L2 as the fused loop leaves it after K2) and
config 5's (G=10, B=4, 4000 lanes; the "high" Gram of all 50 groups over T
= 2e4, one call per group in the staged loop's order, so each group's 13 MB
comes from device memory). Each shape is checked once against the plain
version (A identical, W and dW max |diff|) and a digest of the kernel's
outputs is printed (equal digests: the same outputs, bit for bit). Time:
the kernel's device time per call by torch.profiler (a call's host work
exceeds the kernel's, so CUDA events around back-to-back calls would time
the host), over 20 calls at the flagship and 2 passes of 50 groups at
config 5, three times. ``--tiles 8,16,32`` (this checkout's
``ops/ss_cuda.py::edge_scan_plan`` replaced for the call) times each lane
tile in turns, three rounds.

K4 at (100000, 200), PG(y + 4, psi) with psi = -2 + 0.5 randn and NB counts
y capped at 15 (the NB flagship's draw): the sum's z against pg_mean, the
spread's ratio to pg_var, a digest, and CUDA events around 10 calls, three
times, and the registers and spills of each K4 kernel the build compiled
(nvcc's ptxas report). ``--terms 1,2,8,16`` also runs K4's run-time body
(a checkout whose wrapper takes K) at each of those numbers of series
terms, and at K = 4, where it is held against the four-term body on the
same Philox stream (max relative difference), each with the same z,
spread, digest and times. Each ``--cut`` (K4 only) removes one part of
K4: ``rng`` replaces the Philox calls by a multiplicative hash, ``logs``
lets the squeezes accept every proposal (no log test), ``setup`` replaces
the tail sums by constants; the cut copy of the package goes to ROOT/build/k4_cut_<parts>/
and its draws follow another law by design, so only its time is read.
K5 at (100000, 200) on two count sets: the NB flagship's (y as for K4,
max_y 16) and a high-count one (psi = 0.5 randn, Gamma(4) e^psi Poisson
counts, max_y 64, mean ~4.5), r = 0.5 + 4 U(0, 1) per column. Both forms:
the per-element counts and the column sums (``crt_sample_sums_cuda``; a
checkout without it is timed on its callers' former path, the per-element
kernel and ``torch.sum``, and a checkout with it also on that path, as
``per_element_summed``). Each is checked once: the sums' z against the
exact mean sum_k r / (r + k) over the elements' trials, and a digest.
Time: device time by torch.profiler over 20 calls (all of a call's
kernels, and K5's own apart), CUDA events around 20 calls beside it,
three times each. Each ``--cut`` with ``--only k5`` changes one part of
K5 (the copy goes to ROOT/build/k5_cut_<parts>/; its counts are wrong by
design, so only its time is read): ``rng`` replaces the Philox draw by a
multiplicative hash, ``units`` runs no unit round (no trial past the
first), ``search`` takes a unit's element as s % 128 instead of the
binary search of the unit prefix, ``regs`` caps the registers so that 8
blocks fit an SM.
Prints medians and the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

from timing import crt_z, cut_copy, device_ms, digest, edge_scan_priors

N, T, B, L, G = 200, 100_000, 4, 10, 8
N5, T5, C5, G5 = 500, 20_000, 8, 10
# Each cut of K4: the statement it replaces (old, new) in csrc/pg_gamma.cu.
_CUTS = {
    "rng": ("    const uint4 w = curand_Philox4x32_10(ctr, key);\n",
            "    const uint32_t h = (ctr.x * 0x9E3779B9u) ^ "
            "(ctr.z * 0x85EBCA6Bu) ^ key.x;\n"
            "    const uint4 w = make_uint4(h, h * 0xC2B2AE35u, "
            "h * 0x27D4EB2Fu, h * 0x165667B1u);\n"),
    "logs": ("  if (u * m < m - sq * x4 || u < 1.0f - 0.0331f * x4) "
             "return true;", "  return true;"),
    "setup": ("  tail_sums(a, &S1, &S2, &S3);\n",
              "  S1 = 0.24f; S2 = 0.005f; S3 = 1.5e-4f;\n"),
}


# Each cut of K5: the statement it replaces (old, new) in csrc/crt.cu.
_K5_CUTS = {
    "rng": ("        const uint4 w = philox(make_uint4(q, base + le, off_lo, "
            "off_hi), key);\n",
            "        const uint32_t h = (q * 0x9E3779B9u) ^ ((base + le) * "
            "0x85EBCA6Bu) ^ key.x;\n"
            "        const uint4 w = make_uint4(h, h * 0xC2B2AE35u, "
            "h * 0x27D4EB2Fu, h * 0x165667B1u);\n"),
    "units": ("    if (total > 0) {                        // warp-uniform\n",
              "    if (total < 0) {\n"),
    "search": ("        for (int b = kChunk / 2; b > 0; b >>= 1)\n"
               "          if (s_pref[warp][le + b - 1] <= s) le += b;\n",
               "        le = s & (kChunk - 1);\n"),
    "regs": ("__global__ void __launch_bounds__(kThreads)\n",
             "__global__ void __launch_bounds__(kThreads, 8)\n"),
}


def _k3_cases(gen):
    """{shape: (groups, w0, calls per timed run)}: groups lists each
    group's (jgg, m0, mu, lam, lrho, u_a, eps); group g updates rows
    g GB .. (g + 1) GB of a copy of w0."""
    import torch
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    from pyglm_tpu_torch.ops.gram_cuda import group_gram_blocks_cuda
    from pyglm_tpu_torch.ops.ss_cuda import ss_group_pass_plain
    cases = {}
    GB = G * B
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.05).float()
    xg = design_matrix(Y, cosine_basis(B, L)).T.contiguous()[3 * GB:4 * GB]
    del Y
    omega = 0.05 + 0.2 * torch.rand((T, N), generator=gen, device="cuda")
    u = 0.5 * torch.randn((T, N), generator=gen, device="cuda")
    m0, jgg, _ = ss_group_pass_plain(None, xg, omega, u, None)
    del omega, u
    w0 = (torch.randn((GB, N), generator=gen, device="cuda")
          * (torch.rand((GB, N), generator=gen, device="cuda") < 0.25))
    cases["flagship"] = ([(jgg, m0, *edge_scan_priors(gen, G, N, B))], w0,
                         20)

    lanes, GB = C5 * N5, G5 * B
    Ng = N5 // G5
    Y = (torch.rand((T5, N5), generator=gen, device="cuda") < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(B, L)).T.contiguous()
    del Y
    omega = 0.05 + 0.2 * torch.rand((T5, lanes), generator=gen, device="cuda")
    Jg = group_gram_blocks_cuda(Xt, omega, B, G5, precision="high")
    u = 0.5 * torch.randn((T5, lanes), generator=gen, device="cuda")
    M0 = Xt[:Ng * GB] @ u
    del omega, u, Xt
    w0 = (torch.randn((Ng * GB, lanes), generator=gen, device="cuda")
          * (torch.rand((Ng * GB, lanes), generator=gen, device="cuda")
             < 0.25))
    pri = edge_scan_priors(gen, N5, lanes, B)
    groups = [(Jg[g], M0[g * GB:(g + 1) * GB],
               *(p[g * G5:(g + 1) * G5] for p in pri)) for g in range(Ng)]
    cases["config5"] = (groups, w0, 2)
    return cases


def time_k3(label, card, tiles):
    import torch
    from pyglm_tpu_torch.ops import ss_cuda
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (groups, w0, reps) in _k3_cases(gen).items():
        def run(scan, w):
            return [scan(jgg, m0, w[i * len(m0):(i + 1) * len(m0)], *rest)
                    for i, (jgg, m0, *rest) in enumerate(groups)]
        w_k, w_p = w0.clone(), w0.clone()
        out_k, out_p = run(ss_cuda.ss_edge_scan_cuda, w_k), run(
            ss_cuda.ss_edge_scan_plain, w_p)
        a_k, a_p = (torch.cat([a for _, a in o]) for o in (out_k, out_p))
        d_k, d_p = (torch.cat([d for d, _ in o]) for o in (out_k, out_p))
        n_diff = int((a_k != a_p).sum())
        werr = float((w_k - w_p).abs().max())
        derr = float((d_k - d_p).abs().max())
        dig = digest(w_k, d_k, a_k)
        del out_p, w_p, a_p, d_p
        w_t = w0.clone()
        variants = [None] + list(tiles)
        times = {v: [] for v in variants}
        digests = {}
        plan = getattr(ss_cuda, "edge_scan_plan", None)
        try:
            for _ in range(3):
                for v in variants:
                    if v is not None:
                        ss_cuda.edge_scan_plan = lambda *a, v=v: v
                        if v not in digests:
                            w_v = w0.clone()
                            o = run(ss_cuda.ss_edge_scan_cuda, w_v)
                            digests[v] = digest(
                                w_v, torch.cat([d for d, _ in o]),
                                torch.cat([a for _, a in o]))
                    ms = device_ms(
                        lambda: run(ss_cuda.ss_edge_scan_cuda, w_t), reps)
                    times[v].append(sum(
                        t for k, t in ms.items() if "edge_scan_kernel" in k)
                        / len(groups))
                    if plan is not None:
                        ss_cuda.edge_scan_plan = plan
        finally:
            if plan is not None:
                ss_cuda.edge_scan_plan = plan
        jgg, m0 = groups[0][:2]
        tile = (f", plan tile {plan(m0.shape[0] // B, B, jgg.shape[1])}"
                if plan is not None else "")
        print(f"{label}: K3 {name} ({len(groups)} group(s) of "
              f"{m0.shape[0] // B} edges x {jgg.shape[1]} lanes{tile}) ms "
              f"per call {[round(t, 5) for t in times[None]]}, median "
              f"{statistics.median(times[None]):.5f}; vs plain: A "
              f"{n_diff} of {a_k.numel()} differ ({int(a_k.sum())} active), "
              f"W {werr:.2e}, dW {derr:.2e}; sha256 {dig} ({card})",
              flush=True)
        for v in tiles:
            print(f"{label}: K3 {name} at lane tile {v}: ms "
                  f"{[round(t, 5) for t in times[v]]}, median "
                  f"{statistics.median(times[v]):.5f}, sha256 {digests[v]}",
                  flush=True)


def time_k4(label, card, terms=()):
    import re
    import torch
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.linalg import sample_gamma
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
    from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var
    gen = torch.Generator(device="cuda").manual_seed(4321)
    psi = -2.0 + 0.5 * torch.randn((T, N), generator=gen, device="cuda")
    lam = sample_gamma(torch.full((T, N), 4.0, device="cuda"), gen) * psi.exp()
    b = torch.clamp(torch.poisson(lam, generator=gen), max=15.0) + 4.0
    om = pg_gamma_series_cuda(b, psi, 1, 0, normal_cutoff=170.0).double()
    m, v = pg_mean(b, psi).double(), pg_var(b, psi).double()
    z = float((om.sum() - m.sum()) / v.sum().sqrt())
    ratio = float(((om - m) ** 2).sum() / v.sum())

    def run(reps=10):
        pg_gamma_series_cuda(b, psi, 3, 0, normal_cutoff=170.0)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for i in range(reps):
            pg_gamma_series_cuda(b, psi, 3, i, normal_cutoff=170.0)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    times = [run() for _ in range(3)]
    print(f"{label}: K4 ({T}, {N}) ms {[round(t, 4) for t in times]}, "
          f"median {statistics.median(times):.4f}; sum z {z:.3f}, spread "
          f"ratio {ratio:.5f}, sha256 {digest(om)} ({card})", flush=True)
    lines = _build.LOG_PATH.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "pg_gamma_kernel" in line:
            name = re.search(r"pg_gamma_kernel\w*", line).group(0)
            text = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            print(f"{label}: {name} {regs.group(1) if regs else '?'} "
                  f"registers, {spill.group(1) if spill else 0} B spilled",
                  flush=True)
    for K in terms:
        kw = dict(normal_cutoff=170.0, K=K, run_time_body=True)
        ok = pg_gamma_series_cuda(b, psi, 1, 0, **kw).double()
        zk = float((ok.sum() - m.sum()) / v.sum().sqrt())
        rk = float(((ok - m) ** 2).sum() / v.sum())
        same = (f", max relative difference to the four-term body "
                f"{float(((ok - om) / om).abs().max()):.3e}" if K == 4
                else "")
        tk = []
        for _ in range(3):
            pg_gamma_series_cuda(b, psi, 3, 0, **kw)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for i in range(10):
                pg_gamma_series_cuda(b, psi, 3, i, **kw)
            t1.record()
            t1.synchronize()
            tk.append(t0.elapsed_time(t1) / 10)
        print(f"{label}: K4 run-time body K={K} ({T}, {N}) ms "
              f"{[round(t, 4) for t in tk]}, median "
              f"{statistics.median(tk):.4f}; sum z {zk:.3f}, spread ratio "
              f"{rk:.5f}, sha256 {digest(ok)}{same} ({card})", flush=True)


def _k5_counts(gen, hi):
    """(y int32 (T, N), r (N,), max_y) of one of K5's two count sets."""
    import torch
    from pyglm_tpu_torch.ops.linalg import sample_gamma
    psi = ((0.0 if hi else -2.0)
           + 0.5 * torch.randn((T, N), generator=gen, device="cuda"))
    lam = sample_gamma(torch.full((T, N), 4.0, device="cuda"), gen) * psi.exp()
    y = torch.poisson(lam, generator=gen)
    if not hi:
        y = torch.clamp(y, max=15.0)
    r = 0.5 + 4.0 * torch.rand((N,), generator=gen, device="cuda")
    return y.to(torch.int32), r, 64 if hi else 16


def time_k5(label, card):
    import torch
    from pyglm_tpu_torch.ops import crt_cuda
    sums_fn = getattr(crt_cuda, "crt_sample_sums_cuda", None)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for name, hi in (("nb", False), ("high", True)):
        y, r, max_y = _k5_counts(gen, hi)
        forms = {"per_element": lambda i: crt_cuda.crt_sample_cuda(
            y, r, max_y, 7, i)}
        summed = (lambda i: torch.sum(       # counts, then torch.sum
            crt_cuda.crt_sample_cuda(y, r, max_y, 7, i), dim=0))
        if sums_fn is not None:
            forms["sums"] = lambda i: sums_fn(y, r, max_y, 7, i)
            forms["per_element_summed"] = summed
        else:       # the callers' former path
            forms["sums"] = summed
        for form, fn in forms.items():
            out = fn(0)
            sums = out.sum(0) if form == "per_element" else out
            z = crt_z(sums, y, r, max_y)
            dev, k5, ev = [], [], []
            for _ in range(3):
                ms = device_ms(lambda: fn(1), 20)
                dev.append(sum(ms.values()))
                k5.append(sum(t for k, t in ms.items() if "crt" in k))
                fn(1)
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                for i in range(20):
                    fn(i)
                t1.record()
                t1.synchronize()
                ev.append(t0.elapsed_time(t1) / 20)
            m = y.clamp(0, max_y)
            print(f"{label}: K5 {form} {name} ({T}, {N}, max_y {max_y}, "
                  f"mean count {float(m.float().mean()):.3f}, nonzero "
                  f"{float((m > 0).float().mean()):.4f}, units (Philox "
                  f"draws) an element {float(((m + 2) // 4).float().mean()):.4f}"
                  f"): device ms {[round(t, 5) for t in dev]}, median "
                  f"{statistics.median(dev):.5f} (K5's kernel "
                  f"{statistics.median(k5):.5f}); events ms "
                  f"{[round(t, 5) for t in ev]}, median "
                  f"{statistics.median(ev):.5f}; sums z {z:.3f}; sha256 "
                  f"{digest(out)} ({card})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--only", choices=["k3", "k4", "k5"])
    ap.add_argument("--tiles", default=[],
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--terms", default=[],
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--cut", action="append", default=[],
                    choices=sorted(set(_CUTS) | set(_K5_CUTS)))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.cut and args.only not in ("k4", "k5"):
        raise SystemExit("time_k3_k4: --cut applies to K4 or K5: add "
                         "--only k4 or --only k5")
    if args.cut:
        name, src, cuts = (("k4_cut", "pg_gamma.cu", _CUTS)
                           if args.only == "k4" else
                           ("k5_cut", "crt.cu", _K5_CUTS))
        sys.path.insert(0, str(cut_copy(root, name, src, cuts, args.cut)))
    else:
        sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_k3_k4: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from pyglm_tpu_torch.ops import _build
    _build.build(force=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.only in (None, "k3"):
        time_k3(str(root), card, args.tiles)
    if args.only in (None, "k4"):
        time_k4(f"{root}" + "".join(f" --cut {c}" for c in args.cut), card,
                args.terms)
    if args.only in (None, "k5"):
        time_k5(f"{root}" + "".join(f" --cut {c}" for c in args.cut), card)


if __name__ == "__main__":
    main()
