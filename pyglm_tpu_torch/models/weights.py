"""Collapsed spike-and-slab weight update in residual space (PyTorch
counterpart of the main-path subset of ``pyglm_tpu/models/weights.py``).

Weight layout: P = N*B + 1 design columns, presyn-major (column j*B + b =
presyn neuron j, basis b; last column = bias). w_full[:, n] stacks
A[j,n] * W[j,n,:] for all j, then b[n].

The update keeps the working residual u = kappa - omega * psi and visits
the presyn neurons in Ng groups of G, by one of two loops that draw the
same noise in the same order, so one generator gives the same chain up to
float rounding:

- "fused": per group g, kernel K2 (ops/ss_cuda.py) applies group g-1's
  weight change to u and forms the gather M0 = X_g u and the within-group
  Gram; kernel K3 then runs the collapsed Gibbs over the group's G edges for
  all postsyn lanes at once. The loop shape of the JAX package's mesh path
  (``_ss_fused_shard_map``) without the mesh.
- "staged": kernel K6 (ops/gram_cuda.py) forms every group's Gram in one
  launch; then per group M0 = X_g u (a GEMM), K3, and the scatter
  u -= omega * (X_g^T dW) (a GEMM and one elementwise pass). The JAX
  package's staged path (``_tspace_impl``).

:func:`ss_path` picks the loop where the JAX package's single-device
dispatcher picks it: the fused loop at precision "default", "sr" and
"high", never at "highest". The bias draw follows either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pyglm_tpu_torch.ops.linalg import (
    chol_small, solve_lower_small, solve_lower_t_small,
)
from pyglm_tpu_torch.ops.gram_cuda import (
    group_gram_blocks_cuda, group_gram_blocks_plain,
)
from pyglm_tpu_torch.ops.ss_cuda import (
    _MAX_B, omega_bf16_stream, ss_edge_scan, ss_group_pass, to_bf16,
    unpack_gram,
)
from pyglm_tpu_torch.utils.utils import logistic

# The loop the last resample_spike_slab_tspace call ran: "fused" | "staged".
LAST_SS_PATH = None


class EdgeHypers(NamedTuple):
    """Per-edge prior parameters handed from the network to the weights."""
    mu: torch.Tensor          # (N, N, B)    prior mean of W[pre, post]
    Lam: torch.Tensor         # (N, N, B, B) prior precision
    logit_rho: torch.Tensor   # (N, N)       prior log-odds of A[pre, post]
    mu_b: torch.Tensor        # (N,)         bias prior mean
    lam_b: torch.Tensor       # (N,)         bias prior precision


class SpikeSlabNoise(NamedTuple):
    """The random numbers of one spike-and-slab update, for callers that
    must reproduce a reference chain: per group g and edge i,
    ``a = u_a < p`` and ``w = mu_p + Lp^{-T} eps``; then the bias normal.
    At precision "sr" on the fused loop, `sr` holds each group's (seed,
    offset) of K2's rounding words (``ops/ss_cuda.py::sr_words``); when it
    is None they are drawn from the update's host generator."""
    u_a: torch.Tensor         # (Ng, G, N)
    eps: torch.Tensor         # (Ng, G, N, B)
    bias: torch.Tensor        # (N,)
    sr: torch.Tensor | None = None    # (Ng, 2) int64


def pack_weights(A, W, b):
    """(A, W, b) -> w_full (P, N) in the design-column layout."""
    N, _, B = W.shape
    w = (A[:, :, None] * W).permute(0, 2, 1).reshape(N * B, N)
    return torch.cat([w, b[None, :]], dim=0)


def unpack_weights(w_full, N: int, B: int):
    """w_full (P, N) -> (W_eff (N, N, B), b (N,)); W_eff is masked by A."""
    W = w_full[: N * B].reshape(N, B, N).permute(0, 2, 1)
    return W, w_full[N * B]


def _auto_group(N_pre: int, B: int = 4) -> int:
    """Divisor G of N_pre with G*B % 8 == 0 nearest to 8 (larger on ties),
    else the divisor nearest 5: the JAX package's choice on the TPU
    (G = 8 at N = 200, B = 4)."""
    divs = [g for g in range(1, min(16, N_pre) + 1) if N_pre % g == 0]
    aligned = [g for g in divs if (g * B) % 8 == 0]
    if aligned:
        return min(aligned, key=lambda g: (abs(g - 8), -g))
    return min(divs, key=lambda g: (abs(g - 5), -g))


def _batched_evidence(m, Jjj, mu0, Lam0, ld0_half):
    """Collapsed evidence of one presyn block across all postsyn lanes:
    m (N, B), Jjj (N, B, B), mu0 (N, B), Lam0 (N, B, B), ld0_half (N,).
    Returns (log_ev (N,), mu_p (N, B), Cp (N, B, B))."""
    Cp = chol_small(Lam0 + Jjj)
    bpost = m + torch.einsum("nbc,nc->nb", Lam0, mu0)
    z = solve_lower_small(Cp, bpost)
    quad_p = 0.5 * torch.sum(z * z, dim=-1)
    quad_0 = 0.5 * torch.einsum("nb,nbc,nc->n", mu0, Lam0, mu0)
    logdet_p = torch.log(torch.diagonal(Cp, dim1=-2, dim2=-1)).sum(-1)
    log_ev = quad_p - quad_0 + ld0_half - logdet_p
    return log_ev, solve_lower_t_small(Cp, z), Cp


def _group_edge_scan(Jgg, M0, wg, mu0g, Lam0g, ld0g, lrhog, u_a, eps):
    """Collapsed Gibbs over one group's G presyn blocks, all postsyn lanes
    at once (the plain arithmetic of kernel K3).

    Jgg (N, GB, GB); M0, wg (GB, N); mu0g (G, N, B); Lam0g (G, N, B, B);
    ld0g, lrhog, u_a (G, N); eps (G, N, B).
    Returns (dW = w_new - w_old (GB, N), wg_new (GB, N), a_g (G, N)).
    """
    G, N, B = mu0g.shape
    dW = torch.zeros_like(M0)
    w_cur = wg.clone()
    a_g = torch.empty((G, N), dtype=M0.dtype, device=M0.device)
    for i in range(G):
        li = i * B
        Jrow = Jgg[:, li:li + B, :]
        Jii = Jgg[:, li:li + B, li:li + B]
        wi = w_cur[li:li + B].clone()                       # (B, N)
        m = (M0[li:li + B].T - torch.einsum("nbq,qn->nb", Jrow, dW)
             + torch.einsum("nbc,cn->nb", Jii, wi))
        log_ev, mu_p, Cp = _batched_evidence(m, Jii, mu0g[i], Lam0g[i],
                                             ld0g[i])
        a = u_a[i] < logistic(lrhog[i] + log_ev)
        w_draw = mu_p + solve_lower_t_small(Cp, eps[i])
        w_new = torch.where(a[:, None], w_draw, torch.zeros_like(w_draw))
        dW[li:li + B] = w_new.T - wi
        w_cur[li:li + B] = w_new.T
        a_g[i] = a.to(M0.dtype)
    return dW, w_cur, a_g


# Scoped-vmem budget of the JAX package's monolithic fused TPU kernel
# (pyglm_tpu/models/weights.py); kept only so that ss_path routes a
# configuration as the JAX package does.
_FUSED_VMEM_CAP = int(15.5 * 2 ** 20)


def _fused_vmem_bytes(G: int, B: int, npad: int, tc: int) -> int:
    """The JAX package's estimate of its fused kernel's scoped-vmem stack
    (double-buffered streams and slabs plus the Gram-triangle scratch)."""
    GB = G * B
    G8 = -(-G // 8) * 8
    streams = 2 * 4 * (2 * GB * tc + 3 * tc * npad)
    slabs = 2 * 4 * npad * (3 * GB + G * B * B + 2 * G8 + 8)
    scratch = 4 * npad * (G * (G + 1) // 2 * B * B + 2 * GB)
    return streams + slabs + scratch


def _fused_plan(N_pre: int, B: int, npad: int, t_chunk: int,
                group: int | None = None):
    """(G, tc) of the JAX package's fused kernel, or None when no group
    fits its budget (npad around 4096 and wider)."""
    if group is not None:
        gs = [group]
    else:
        gs = sorted((g for g in range(1, min(16, N_pre) + 1)
                     if N_pre % g == 0 and (g * B) % 8 == 0),
                    key=lambda g: (abs(g - 8), -g))
    for g in gs:
        tc = max(t_chunk, 1024)
        while tc >= 128:
            if _fused_vmem_bytes(g, B, npad, tc) <= _FUSED_VMEM_CAP:
                return g, tc
            tc //= 2
    return None


# Precision modes, as in the JAX package. The spike-and-slab Gram on the
# card: "high" 3xTF32 (K2 in the fused loop, K6's "high" body in the staged
# loop); "default" one bf16 pass (K2's bf16 Gram, K6's bf16 body); "sr" one
# bf16 pass on a stochastically rounded Z in the fused loop (K2) and, as in
# the JAX package, the "high" Gram in the staged loop; "highest" the staged
# loop on K6's fp32 FMA body.
PRECISIONS = ("default", "sr", "high", "highest")


def check_precision(precision: str) -> None:
    """Raise for an unknown precision mode."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: one of {PRECISIONS}")


def ss_path(N_pre: int, B: int, lanes: int, T: int, group: int | None = None,
            jg_given: bool = False, precision: str = "highest") -> str:
    """"staged" or "fused": the loop the JAX package's single-device
    dispatcher (``_tspace_impl``) picks for this configuration, without its
    backend tests (TPU, device count, mesh, environment). The same
    configuration then runs the same algorithm in both packages; on the
    card both loops are hand-written kernels, so neither is a fallback and
    nothing warns. "highest" always runs the staged loop, as in the JAX
    package. Which loop is faster at wide lanes is measured in PERF.md."""
    check_precision(precision)
    plan = _fused_plan(N_pre, B, -(-lanes // 128) * 128, 512, group=group)
    if (precision == "highest" or jg_given or T < 384 or B > _MAX_B
            or plan is None or (plan[0] * B) % 8):
        return "staged"
    return "fused"


def group_gram_blocks(Xt, omega, B: int, G: int, packed: bool = True,
                      fast: bool = False, precision: str = "highest"):
    """Every group's omega-weighted Gram: kernel K6 for CUDA tensors, its
    plain version for CPU tensors. The body, as the JAX package picks its
    Pallas body: ``fast=True`` or precision "default" the single bf16 pass
    (``_gram_kernel_fast``), "high" and "sr" 3xTF32 (``_gram_kernel_f32``;
    the JAX package's "sr" takes it too), "highest" fp32 FMA (its f32 XLA
    Gram); on the CPU the bf16 body is the plain bf16 Gram and the others
    fp32. Xt (P, T) with the bias row last. Returns the packed
    (Ng, GB(GB+1)/2, N), or with ``packed=False`` the JAX package's
    (Ng, N, GB, GB)."""
    check_precision(precision)
    body = ("default" if fast or precision == "default" else
            "highest" if precision == "highest" else "high")
    if omega.is_cuda:
        Jg = group_gram_blocks_cuda(Xt, omega, B, G, precision=body)
    elif omega.device.type == "cpu":
        Jg = group_gram_blocks_plain(Xt, omega, B, G, precision=body)
    else:
        raise ValueError(f"group_gram_blocks: unsupported device "
                         f"{omega.device}")
    if packed:
        return Jg
    return torch.stack([unpack_gram(j, G * B) for j in Jg])


def _draw_group_noise(generator, noise, g, G, N, B, dev):
    """Group g's (u_a (G, N), eps (G, N, B)): drawn, or taken from noise."""
    if noise is not None:
        return noise.u_a[g].contiguous(), noise.eps[g].contiguous()
    return (torch.rand((G, N), generator=generator, device=dev),
            torch.randn((G, N, B), generator=generator, device=dev))


def _sr_seeds(host_generator, noise, Ng):
    """The (Ng, 2) (seed, offset) pairs of K2's "sr" rounding words, one
    per group: ``noise.sr`` if given, else one draw from the host
    generator."""
    if noise is not None and noise.sr is not None:
        return noise.sr.tolist()
    if host_generator is None:
        raise ValueError("precision='sr' on the fused loop draws K2's "
                         "rounding seeds: pass host_generator or noise.sr")
    return torch.randint(0, 2 ** 62, (Ng, 2),
                         generator=host_generator).tolist()


def _fused_loop(generator, host_generator, Xt, omega, u, w, hyp, A, G, B,
                noise, precision):
    """Ng x (K2 + K3) and K2's epilogue, K2's Gram at `precision`; updates
    u, w and A in place and returns sum_t omega. At "default" and "sr" the
    Grams read one bf16 stream of omega (omega holds bf16 values there),
    made here once for the update's Ng K2 calls."""
    T, N = omega.shape
    GB, Ng = G * B, A.shape[0] // G
    sr = _sr_seeds(host_generator, noise, Ng) if precision == "sr" else None
    om16 = omega_bf16_stream(omega) if precision != "high" else None
    dW = sum_om = None
    for g in range(Ng + 1):
        xp = Xt[(g - 1) * GB: g * GB] if g > 0 else None
        xg = Xt[g * GB:(g + 1) * GB] if g < Ng else None
        sr_seed = tuple(sr[g]) if sr is not None and xg is not None else (0, 0)
        m0, jgg, s = ss_group_pass(xp, xg, omega, u, dW,
                                   want_sum_omega=(g == 0),
                                   precision=precision, sr_seed=sr_seed,
                                   om16=om16)
        if g == 0:
            sum_om = s
        if g == Ng:
            break
        u_a, eps = _draw_group_noise(generator, noise, g, G, N, B, u.device)
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(jgg, m0, w[g * GB:(g + 1) * GB], hyp.mu[sl],
                                 hyp.Lam[sl], hyp.logit_rho[sl], u_a, eps)
    return sum_om


def _staged_loop(generator, Xt, omega, u, w, hyp, A, G, B, noise, precision,
                 Jg=None):
    """K6 once (unless the packed Jg is given), then per group M0 = X_g u,
    K3 on Jg[g] and the scatter u -= omega * (X_g^T dW); updates u, w and A
    in place and returns sum_t omega."""
    N = omega.shape[1]
    GB = G * B
    if Jg is None:
        Jg = group_gram_blocks(Xt, omega, B, G, precision=precision)
    for g in range(Jg.shape[0]):
        xg = Xt[g * GB:(g + 1) * GB]
        m0 = xg @ u
        u_a, eps = _draw_group_noise(generator, noise, g, G, N, B, u.device)
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(Jg[g], m0, w[g * GB:(g + 1) * GB],
                                 hyp.mu[sl], hyp.Lam[sl], hyp.logit_rho[sl],
                                 u_a, eps)
        u.addcmul_(omega, xg.T @ dW, value=-1.0)
    return omega.sum(0)


def resample_spike_slab_tspace(generator: torch.Generator, Xt, omega, kappa,
                               psi, w_full, hyp: EdgeHypers, B: int,
                               group: int | None = None,
                               noise: SpikeSlabNoise | None = None,
                               path: str | None = None, Jg=None,
                               precision: str = "highest",
                               host_generator: torch.Generator | None = None):
    """Collapsed spike-and-slab for all neurons in residual (T-) space.

    Args:
      generator: draws the update's noise on omega's device (unless
        `noise` is given).
      Xt: (P, T) transposed design; omega, kappa, psi: (T, N).
      w_full: (P, N) current packed weights; hyp: per-edge priors.
      group: presyn neurons per group (default :func:`_auto_group`).
      noise: the update's random numbers, to reproduce a reference chain.
      path: "fused" or "staged" to force a loop (default :func:`ss_path`).
      Jg: every group's packed Gram (:func:`group_gram_blocks`), to run the
        staged loop on it instead of forming it.
      precision: the Gram's mode, as in the JAX package. "high": 3xTF32
        on the card (K2 in the fused loop where :func:`ss_path` picks it,
        else K6's "high" body). "default": one bf16 pass (K2's bf16 Gram,
        K6's bf16 body). "sr": in the fused loop K2's bf16 pass on a
        stochastically rounded Z; in the staged loop the "high" Gram, as
        the JAX package runs it (the launch counts show which ran).
        "highest": the staged loop on K6's fp32 body (a forced "fused"
        raises). In the fused loop at "default" and "sr", omega is rounded
        to bf16 once and that value feeds u0, every K2 call and sum_omega,
        while the bias scatter takes the float32 omega, as the JAX fused
        kernel does (``weights.py:709-715``); K2's Grams read it as one
        bf16 stream made once per update. On the CPU the plain versions
        repeat each mode's rounding; "high" and "highest" are fp32 there.
      host_generator: a CPU generator that draws, in one (Ng, 2) draw, the
        (seed, offset) of each K2 call's rounding words at "sr" in the
        fused loop (unless ``noise.sr`` is given); no other mode draws
        from it.

    Returns (A (N_pre, N), w_full (P, N), u (T, N), sum_omega (N,)); psi
    under the new weights is (kappa - u) / omega. The loop run is recorded
    in ``LAST_SS_PATH``.
    """
    global LAST_SS_PATH
    T, N = omega.shape
    P = w_full.shape[0]
    N_pre = (P - 1) // B
    G = _auto_group(N_pre, B) if group is None else group
    if N_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={N_pre}")
    if path is None:
        path = ss_path(N_pre, B, N, T, group=group, jg_given=Jg is not None,
                       precision=precision)
    check_precision(precision)
    if path not in ("fused", "staged") or (Jg is not None
                                          and path != "staged"):
        raise ValueError(f"path={path!r}: 'fused' or 'staged' (a given Jg "
                         f"runs the staged loop)")
    if path == "fused" and precision == "highest":
        raise ValueError("path='fused' runs K2, whose Gram is not fp32; "
                         "precision='highest' runs the staged loop")
    LAST_SS_PATH = path
    dev = omega.device

    # The fused loop's omega at the bf16 modes (ss_pallas.py:409-413).
    om_k = (to_bf16(omega) if path == "fused"
            and precision in ("default", "sr") else omega)
    u = kappa - om_k * psi
    w = w_full.clone()
    hyp = hyp._replace(mu=hyp.mu.contiguous(), Lam=hyp.Lam.contiguous(),
                       logit_rho=hyp.logit_rho.contiguous())
    A = torch.empty((N_pre, N), dtype=torch.float32, device=dev)
    if path == "staged":
        sum_om = _staged_loop(generator, Xt, omega, u, w, hyp, A, G, B,
                              noise, precision, Jg)
    else:
        sum_om = _fused_loop(generator, host_generator, Xt, om_k, u, w, hyp,
                             A, G, B, noise, precision)

    # Bias column (always active): X_bias = ones.
    b_old = w[P - 1].clone()
    m_b = u.sum(0) + sum_om * b_old + hyp.lam_b * hyp.mu_b
    lam_p = hyp.lam_b + sum_om
    z_b = (torch.randn((N,), generator=generator, device=dev)
           if noise is None else noise.bias)
    b_new = m_b / lam_p + z_b / torch.sqrt(lam_p)
    u -= omega * (b_new - b_old)[None, :]
    w[P - 1] = b_new
    return A, w, u, sum_om
