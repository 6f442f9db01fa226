"""Collapsed spike-and-slab weight update in residual space (PyTorch
counterpart of the main-path subset of ``pyglm_tpu/models/weights.py``).

Weight layout: P = N*B + 1 design columns, presyn-major (column j*B + b =
presyn neuron j, basis b; last column = bias). w_full[:, n] stacks
A[j,n] * W[j,n,:] for all j, then b[n].

The update keeps the working residual u = kappa - omega * psi and visits
the presyn neurons in Ng groups of G. Per group g, kernel K2
(ops/ss_cuda.py) applies group g-1's weight change to u and forms the
gather M0 = X_g u and the within-group Gram; kernel K3 then runs the
collapsed Gibbs over the group's G edges for all postsyn lanes at once.
This is the loop shape of the JAX package's mesh path
(``_ss_fused_shard_map``) without the mesh. The bias draw follows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pyglm_tpu_torch.ops.linalg import (
    chol_small, solve_lower_small, solve_lower_t_small,
)
from pyglm_tpu_torch.ops.ss_cuda import ss_edge_scan, ss_group_pass
from pyglm_tpu_torch.utils.utils import logistic


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
    ``a = u_a < p`` and ``w = mu_p + Lp^{-T} eps``; then the bias normal."""
    u_a: torch.Tensor         # (Ng, G, N)
    eps: torch.Tensor         # (Ng, G, N, B)
    bias: torch.Tensor        # (N,)


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


def resample_spike_slab_tspace(generator: torch.Generator, Xt, omega, kappa,
                               psi, w_full, hyp: EdgeHypers, B: int,
                               group: int | None = None,
                               noise: SpikeSlabNoise | None = None):
    """Collapsed spike-and-slab for all neurons in residual (T-) space.

    Args:
      generator: draws the update's noise on omega's device (unless
        `noise` is given).
      Xt: (P, T) transposed design; omega, kappa, psi: (T, N).
      w_full: (P, N) current packed weights; hyp: per-edge priors.
      group: presyn neurons per group (default :func:`_auto_group`).
      noise: the update's random numbers, to reproduce a reference chain.

    Returns (A (N_pre, N), w_full (P, N), u (T, N), sum_omega (N,)); psi
    under the new weights is (kappa - u) / omega.
    """
    T, N = omega.shape
    P = w_full.shape[0]
    N_pre = (P - 1) // B
    G = _auto_group(N_pre, B) if group is None else group
    if N_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={N_pre}")
    Ng = N_pre // G
    GB = G * B
    dev = omega.device
    f32 = torch.float32

    u = kappa - omega * psi
    w = w_full.clone()
    mu = hyp.mu.contiguous()
    lam = hyp.Lam.contiguous()
    lrho = hyp.logit_rho.contiguous()
    A = torch.empty((N_pre, N), dtype=f32, device=dev)
    dW = None
    sum_om = None
    for g in range(Ng + 1):
        xp = Xt[(g - 1) * GB: g * GB] if g > 0 else None
        xg = Xt[g * GB:(g + 1) * GB] if g < Ng else None
        m0, jgg, s = ss_group_pass(xp, xg, omega, u, dW,
                                   want_sum_omega=(g == 0))
        if g == 0:
            sum_om = s
        if g == Ng:
            break
        if noise is None:
            u_a = torch.rand((G, N), generator=generator, device=dev)
            eps = torch.randn((G, N, B), generator=generator, device=dev)
        else:
            u_a, eps = noise.u_a[g], noise.eps[g]
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(jgg, m0, w[g * GB:(g + 1) * GB], mu[sl],
                                 lam[sl], lrho[sl], u_a.contiguous(),
                                 eps.contiguous())

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
