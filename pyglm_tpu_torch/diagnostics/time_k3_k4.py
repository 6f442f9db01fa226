"""Device time of kernels K3 (the spike-and-slab edge scan,
``csrc/ss_edge_scan.cu``) and K4 (gamma-series PG(b, c),
``csrc/pg_gamma.cu``) at the main paths' shapes, for the package of a given
checkout.

    python pyglm_tpu_torch/diagnostics/time_k3_k4.py [ROOT] [--only k3|k4]
        [--tiles 8,16,32] [--cut rng|logs|setup]...

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
times. Each ``--cut`` (K4 only) removes one part of K4: ``rng`` replaces
the Philox calls by a multiplicative hash, ``logs`` lets the squeezes
accept every proposal (no log test), ``setup`` replaces the tail sums by
constants; the cut copy of the package goes to ROOT/build/k4_cut_<parts>/
and its draws follow another law by design, so only its time is read.
Prints medians and the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

from timing import cut_copy, device_ms, digest, edge_scan_priors

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


def time_k4(label, card):
    import torch
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--only", choices=["k3", "k4"])
    ap.add_argument("--tiles", default=[],
                    type=lambda s: [int(x) for x in s.split(",")])
    ap.add_argument("--cut", action="append", default=[],
                    choices=sorted(_CUTS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if args.cut and args.only != "k4":
        raise SystemExit("time_k3_k4: --cut applies to K4: add --only k4")
    sys.path.insert(0, str(cut_copy(root, "k4_cut", "pg_gamma.cu", _CUTS,
                                    args.cut) if args.cut else root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_k3_k4: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from pyglm_tpu_torch.ops import _build
    _build.build(force=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.only != "k4":
        time_k3(str(root), card, args.tiles)
    if args.only != "k3":
        time_k4(f"{root}" + "".join(f" --cut {c}" for c in args.cut), card)


if __name__ == "__main__":
    main()
