"""One Gibbs sweep of the network GLM in float64: psi, the Polya-gamma
moments, the collapsed spike-and-slab update of (A, W) and the bias
(Linderman, Adams and Pillow 2016, with Polson, Scott and Windle 2013's
augmentation).

Weights are packed per postsynaptic lane: w[j*B + k, n] = A[j, n]
W[j, n, k], the bias last. C stacked chains lie side by side, chain-major
(lane c*N + n). The update visits the presynaptic neurons in groups of G
and, within a group, one neuron at a time, for all lanes at once:

  m_i = X_i' u + (X_i' Omega X_i) w_i - (X_i' Omega X_g) dW_g
  log E_i = 1/2 |Cp^{-1}(m_i + Lam0 mu0)|^2 - 1/2 mu0' Lam0 mu0
            + 1/2 log|Lam0| - log|Cp|,   Cp Cp' = Lam0 + X_i' Omega X_i
  a_i = [u_a < logistic(logit rho_i + log E_i)]
  w_i = a_i (Cp'^{-1} Cp^{-1}(m_i + Lam0 mu0) + Cp'^{-1} eps)

with u = kappa - omega psi the working residual, updated by each group's
change; then b ~ N(m_b / lam_p, 1 / lam_p). The noise (u_a, eps, then the
bias normals) is read from the program's generator state in the order the
update draws it.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64


def pack(A, W, b) -> torch.Tensor:
    """(P, lanes) float64 from A (N, N) or (C, N, N), W (.., N, N, B) and
    b (.., N); stacked chains are chain-major lanes."""
    A, W, b = A.to(F64), W.to(F64), b.to(F64)
    if A.ndim == 2:
        A, W, b = A[None], W[None], b[None]
    C, N, _, B = W.shape
    w = (A[..., None] * W).permute(0, 1, 3, 2).reshape(C, N * B, N)
    w = torch.cat([w, b[:, None, :]], dim=1)            # (C, P, N)
    return w.permute(1, 0, 2).reshape(N * B + 1, C * N)


def unpack_A(A) -> torch.Tensor:
    """A (N, N) or (C, N, N) as (N, lanes)."""
    A = A.to(F64)
    if A.ndim == 2:
        return A
    C, N, _ = A.shape
    return A.permute(1, 0, 2).reshape(N, C * N)


def pg_moments(b, c):
    """Mean and variance of PG(b, c), elementwise in float64:
    b tanh(c/2) / (2c) and b (sinh c - c) / (4 c^3 cosh^2(c/2)), the
    latter as b (2 tanh(c/2) - c sech^2(c/2)) / (4 c^3); series below
    |c| = 1e-3."""
    c = c.abs().to(F64)
    small = c < 1e-3
    cs = torch.where(small, torch.ones_like(c), c)
    th = torch.tanh(cs / 2)
    sech2 = 1.0 / torch.cosh(cs / 2) ** 2
    mean = torch.where(small, 0.25 - c * c / 48, th / (2 * cs))
    var = torch.where(small, 1.0 / 24 - c * c / 120,
                      (2 * th - cs * sech2) / (4 * cs ** 3))
    return b * mean, b * var


def pg_cumulant4(b, c, terms: int = 64):
    """Fourth cumulant of PG(b, c), elementwise in float64. PG(b, c) is
    sum_k g_k / (2 pi^2 d_k) with g_k ~ Gamma(b, 1) and d_k = (k - 1/2)^2
    + c^2 / (4 pi^2), so kappa_4 = 6 b sum_k (2 pi^2 d_k)^-4; the terms
    past `terms` add less than 1 / (7 terms^7) to the sum of d_k^-4."""
    s2 = (c.to(F64) / (2 * math.pi)) ** 2
    acc = torch.zeros_like(s2)
    for k in range(1, terms + 1):
        acc += (s2 + (k - 0.5) ** 2).pow_(-4)
    return 6 * b * acc / (2 * math.pi ** 2) ** 4


def replay_noise(dev_state, dev, Ng: int, G: int, lanes: int, B: int):
    """The update's u_a (Ng, G, lanes), eps (Ng, G, lanes, B) and bias
    normals (lanes,), drawn as the update draws them from a generator in
    `dev_state`; float32 draws returned in float64."""
    g = torch.Generator(device=dev)
    g.set_state(dev_state)
    u_a, eps = [], []
    for _ in range(Ng):
        u_a.append(torch.rand((G, lanes), generator=g, device=dev))
        eps.append(torch.randn((G, lanes, B), generator=g, device=dev))
    z_b = torch.randn((lanes,), generator=g, device=dev)
    return torch.stack(u_a).to(F64), torch.stack(eps).to(F64), z_b.to(F64)


def _solve(C, b, upper=False):
    """C x = b (C lower), or C' x = b with upper=True; b (..., B)."""
    M = C.transpose(-1, -2) if upper else C
    return torch.linalg.solve_triangular(M, b[..., None],
                                         upper=upper)[..., 0]


def spike_slab(X, omega, kappa, psi, w0, hyp: dict, B: int, G: int,
               noise):
    """The collapsed update from w0 (P, lanes). X (T, P), omega, kappa,
    psi (T, lanes); hyp: mu (N_pre, lanes, B), Lam (N_pre, lanes, B, B),
    lrho (N_pre, lanes), mu_b, lam_b (lanes,). Returns (A (N_pre, lanes),
    w (P, lanes)), float64."""
    u_a, eps, z_b = noise
    T, P = X.shape
    lanes = omega.shape[1]
    N_pre = (P - 1) // B
    GB, Ng = G * B, N_pre // G
    om = omega.to(F64)
    u = kappa - om * psi
    w = w0.clone()
    A = torch.empty((N_pre, lanes), dtype=F64, device=X.device)
    p_idx, q_idx = torch.triu_indices(GB, GB, device=X.device)
    ld0 = torch.log(torch.diagonal(torch.linalg.cholesky(hyp["Lam"]),
                                   dim1=-2, dim2=-1)).sum(-1)
    quad0 = 0.5 * torch.einsum("jnb,jnbc,jnc->jn", hyp["mu"], hyp["Lam"],
                               hyp["mu"])
    h0 = torch.einsum("jnbc,jnc->jnb", hyp["Lam"], hyp["mu"])
    for g in range(Ng):
        Xg = X[:, g * GB:(g + 1) * GB]
        Jp = (Xg[:, p_idx] * Xg[:, q_idx]).T @ om          # (npair, lanes)
        J = torch.zeros((lanes, GB, GB), dtype=F64, device=X.device)
        J[:, p_idx, q_idx] = Jp.T
        J[:, q_idx, p_idx] = Jp.T
        M0 = Xg.T @ u                                       # (GB, lanes)
        dW = torch.zeros_like(M0)
        for i in range(G):
            j, sl = g * G + i, slice(i * B, (i + 1) * B)
            Jii = J[:, sl, sl]
            wi = w[g * GB + i * B:g * GB + (i + 1) * B].T       # (lanes, B)
            m = (M0[sl].T - torch.einsum("nbq,qn->nb", J[:, sl, :], dW)
                 + torch.einsum("nbc,nc->nb", Jii, wi))
            Cp = torch.linalg.cholesky(hyp["Lam"][j] + Jii)
            z = _solve(Cp, m + h0[j])
            log_ev = (0.5 * (z * z).sum(-1) - quad0[j] + ld0[j]
                      - torch.log(torch.diagonal(Cp, dim1=-2,
                                                 dim2=-1)).sum(-1))
            a = u_a[g, i] < torch.sigmoid(hyp["lrho"][j] + log_ev)
            w_draw = _solve(Cp, z + eps[g, i], upper=True)
            w_new = torch.where(a[:, None], w_draw, torch.zeros_like(w_draw))
            dW[sl] = (w_new - wi).T
            w[g * GB + i * B:g * GB + (i + 1) * B] = w_new.T
            A[j] = a.to(F64)
        u -= om * (Xg @ dW)
    sum_om, b_old = om.sum(0), w[P - 1].clone()
    m_b = u.sum(0) + sum_om * b_old + hyp["lam_b"] * hyp["mu_b"]
    lam_p = hyp["lam_b"] + sum_om
    w[P - 1] = m_b / lam_p + z_b / torch.sqrt(lam_p)
    return A, w
