"""Wrapper of kernel K7 (``csrc/ld_hmc.cu``): the latent-distance prior's
HMC move, every trajectory of C chains in one launch. The plain version is
``models/networks.py::LatentDistanceConfig._hmc_plain``."""
from __future__ import annotations

import math

import torch

from pyglm_tpu_torch.ops import _build

# The kernel's constants (csrc/ld_hmc.cu): threads a CTA, the largest
# cluster, the partial-sum bytes before the own rows' arrays.
THREADS = 512
MAX_CLUSTER = 8
_HEAD_BYTES = 2 * MAX_CLUSTER * 2 * 8 + (THREADS // 32) * 2 * 8
# Rows a CTA takes at least before the chain is split over more CTAs, and at
# most (the own rows' arrays stay a fraction of shared memory).
MIN_ROWS, MAX_ROWS = 64, 512
MAX_DIM = 8
SMEM_BYTES = 232448            # a block's shared memory on the H100


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def ld_hmc_plan(N: int, dim: int) -> dict:
    """K7's layout for chains of N positions in `dim` dimensions: a cluster
    of `cluster` CTAs per chain (a power of two, 8 at N > 256), each owning
    `rows` = ceil(N / cluster) rows; the two position buffers and the CTA's
    rows of A + A^T in shared memory where they fit (`pos_in_smem`,
    `slab_in_smem`, positions first), else in global scratch; `smem` the
    bytes of shared memory a CTA asks for."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"K7 takes 1 <= dim <= {MAX_DIM}, got {dim}")
    if not 1 <= N <= MAX_CLUSTER * MAX_ROWS:
        raise ValueError(f"K7 takes 1 <= N <= {MAX_CLUSTER * MAX_ROWS}, "
                         f"got {N}")
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * MIN_ROWS < N:
        cluster *= 2
    rows = math.ceil(N / cluster)
    smem = _HEAD_BYTES + _align16(5 * rows * dim * 4)
    pos = 2 * _align16(N * dim * 4)
    pos_in_smem = smem + pos <= SMEM_BYTES
    smem += pos if pos_in_smem else 0
    slab = _align16(rows * N)
    slab_in_smem = smem + slab <= SMEM_BYTES
    smem += slab if slab_in_smem else 0
    return {"cluster": cluster, "rows": rows, "pos_in_smem": pos_in_smem,
            "slab_in_smem": slab_in_smem, "smem": smem}


def check_ld_hmc(L, gamma, A, mom_L, mom_gamma, u_hmc, steps: int) -> None:
    """Raise on what K7 does not take: shapes, float32, contiguity, then
    one CUDA device. L (C, N, dim), gamma (C,), A (C, N, N), mom_L (C,
    iters, N, dim), mom_gamma and u_hmc (C, iters)."""
    if L.ndim != 3:
        raise ValueError(f"ld_hmc_cuda needs L of shape (C, N, dim), got "
                         f"{tuple(L.shape)}")
    C, N, dim = L.shape
    k = mom_L.shape[1] if mom_L.ndim == 4 else -1
    want = {"L": (C, N, dim), "gamma": (C,), "A": (C, N, N),
            "mom_L": (C, k, N, dim), "mom_gamma": (C, k), "u_hmc": (C, k)}
    args = {"L": L, "gamma": gamma, "A": A, "mom_L": mom_L,
            "mom_gamma": mom_gamma, "u_hmc": u_hmc}
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"ld_hmc_cuda: {name} must have shape "
                             f"{want[name]}, got {tuple(x.shape)}")
    if not 1 <= C <= 65535:
        raise ValueError(f"ld_hmc_cuda takes 1 <= C <= 65535 chains, got {C}")
    ld_hmc_plan(N, dim)
    if steps < 1:
        raise ValueError(f"ld_hmc_cuda needs hmc_steps >= 1, got {steps}")
    for name, x in args.items():
        if x.dtype != torch.float32:
            raise TypeError(f"ld_hmc_cuda needs float32, got {name} "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"ld_hmc_cuda needs contiguous tensors "
                             f"({name} is not)")
    if not all(x.is_cuda and x.device == L.device for x in args.values()):
        raise ValueError("ld_hmc_cuda needs CUDA tensors on one device, got "
                         f"{sorted({str(x.device) for x in args.values()})}")


def ld_hmc_cuda(L, gamma, A, mom_L, mom_gamma, u_hmc, eps: float,
                steps: int, sigma_l: float, sigma_gamma: float):
    """hmc_iters = mom_L.shape[1] trajectories of `steps` merged-kick
    leapfrog steps of size `eps` for each of C chains, in one launch, with
    the MH test log u_hmc[c, t] < U + K0 - Un - K1. A holds 0s and 1s.
    Returns (L (C, N, dim), gamma (C,), accepted trajectories (C,) int32).
    Nothing waits for the card."""
    check_ld_hmc(L, gamma, A, mom_L, mom_gamma, u_hmc, steps)
    C, N, dim = L.shape
    plan = ld_hmc_plan(N, dim)
    dev = L.device
    L_out, g_out = torch.empty_like(L), torch.empty_like(gamma)
    count = torch.empty((C,), dtype=torch.int32, device=dev)
    pos_g = (None if plan["pos_in_smem"] else
             torch.empty((C, 2, N, dim), dtype=torch.float32, device=dev))
    slab_g = (None if plan["slab_in_smem"] else
              torch.empty((C, N, N), dtype=torch.uint8, device=dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ld_hmc_launch(
            L.data_ptr(), gamma.data_ptr(), A.data_ptr(), mom_L.data_ptr(),
            mom_gamma.data_ptr(), u_hmc.data_ptr(), L_out.data_ptr(),
            g_out.data_ptr(), count.data_ptr(),
            None if pos_g is None else pos_g.data_ptr(),
            None if slab_g is None else slab_g.data_ptr(),
            C, N, dim, mom_L.shape[1], steps, eps, 0.5 * eps,
            1.0 / sigma_l ** 2, 1.0 / sigma_gamma ** 2, plan["cluster"],
            plan["rows"], int(plan["pos_in_smem"]),
            int(plan["slab_in_smem"]), plan["smem"],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ld_hmc")
    _build.LAUNCHES["ld_hmc"] += 1
    return L_out, g_out, count


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def plain_agreement(cfg, L, gamma, A, noise, delta: float = 1e-3) -> dict:
    """K7 against its plain version on the same tensors and noise (CUDA,
    float32), as the card's tests and chip_smoke.py compare them. The plain
    move in float64 gives each trajectory's margin log u - log alpha; the
    trajectories before the first whose margin lies within `delta` on any
    chain are then run by K7 (``cfg._hmc``) and by the plain move in
    float64 and in float32. Returns the number compared (`iters`), the
    accept counts of each (`counts_k7`, `counts_f64`, `counts_f32`), K7's
    largest relative gaps, max |a - b| / max |b|, from each (`L_f64`,
    `gamma_f64`, `L_f32`, `gamma_f32`; the float32 ones over the chains
    whose counts equal the float64 ones), its largest |L - L_f64|
    (`L_abs_f64`) and the smallest |margin| of those trajectories
    (`margin`)."""
    import dataclasses

    def f64(x):
        return x.double()
    noise64 = noise._replace(mom_L=f64(noise.mom_L),
                             mom_gamma=f64(noise.mom_gamma),
                             u_hmc=f64(noise.u_hmc))
    ratios = []
    cfg._hmc_plain(f64(L), f64(gamma), f64(A), noise64, log_ratios=ratios)
    margins = (torch.log(noise64.u_hmc) - torch.stack(ratios, dim=1)).abs()
    close = (margins <= delta).any(dim=0).nonzero()
    T = int(close[0]) if len(close) else cfg.hmc_iters
    cut = dataclasses.replace(cfg, hmc_iters=T)

    def first(nz):
        return nz._replace(mom_L=nz.mom_L[:, :T],
                           mom_gamma=nz.mom_gamma[:, :T],
                           u_hmc=nz.u_hmc[:, :T])
    out = {"iters": T, "margin": float(margins[:, :T].min()) if T else None}
    runs = {"k7": cut._hmc(L, gamma, A, first(noise)),
            "f64": cut._hmc_plain(f64(L), f64(gamma), f64(A), first(noise64)),
            "f32": cut._hmc_plain(L, gamma, A, first(noise))}
    counts = {k: (r[2].double() * T).round().long().cpu()
              for k, r in runs.items()}
    out.update({f"counts_{k}": v.tolist() for k, v in counts.items()})
    (Lk, gk, _), (L64, g64, _), (L32, g32, _) = runs.values()
    same = (counts["f32"] == counts["f64"]).to(L.device)
    out.update(L_f64=_rel(Lk, L64), gamma_f64=_rel(gk, g64),
               L_abs_f64=float((Lk.double() - L64).abs().max()),
               L_f32=_rel(Lk[same], L32[same]) if same.any() else 0.0,
               gamma_f32=_rel(gk[same], g32[same]) if same.any() else 0.0)
    return out
