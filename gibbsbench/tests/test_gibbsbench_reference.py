"""The float64 reference against independent float64 formulations at tiny
shapes, and its draws against the program's on the CPU from the same
generator states."""
import math

import numpy as np
import pytest
import scipy.stats
import torch

from gibbsbench.reference import glm, networks, samplers
from gibbsbench.reference.design import cosine_basis, design

F64 = torch.float64


def test_design_is_the_causal_convolution():
    g = torch.Generator().manual_seed(0)
    Y = (torch.rand((50, 3), generator=g) < 0.3).float()
    X = design(Y, 4, 10).numpy()
    basis = cosine_basis(4, 10)
    for j in range(3):
        for k in range(4):
            full = np.convolve(Y[:, j].double().numpy(),
                               np.concatenate([[0.0], basis[:, k]]))
            np.testing.assert_allclose(X[:, j * 4 + k], full[:50],
                                       atol=1e-14)
    assert np.all(X[:, -1] == 1.0)


@pytest.mark.parametrize("c", [0.0, 1e-4, 0.3, 2.0, 9.0, 40.0])
def test_pg_moments_against_the_series(c):
    K = 200000
    k = np.arange(1, K + 1, dtype=np.float64)
    d = (k - 0.5) ** 2 + c * c / (4 * math.pi ** 2)
    # The terms past K, by their integral: 1/K and 1/(3 K^3).
    mean = ((1.0 / d).sum() + 1.0 / K) / (2 * math.pi ** 2)
    var = ((1.0 / d ** 2).sum() + 1.0 / (3 * K ** 3)) / (4 * math.pi ** 4)
    m, v = glm.pg_moments(torch.tensor(2.0, dtype=F64),
                          torch.tensor(c, dtype=F64))
    assert float(m) == pytest.approx(2 * mean, rel=1e-5)
    assert float(v) == pytest.approx(2 * var, rel=1e-5)


@pytest.mark.parametrize("c", [0.0, 0.3, 2.0, 9.0, 40.0])
def test_pg_fourth_cumulant_against_the_laplace_transform(c):
    """The fourth derivative at 0 of log E exp(s omega) = log cosh(c/2)
    - log cosh(sqrt(c^2/4 - s/2)), the cumulant generating function of
    PG(1, c), in 40-digit arithmetic (its real part: cosh(sqrt(z)) is
    even in sqrt(z)); and at c = 0 the closed form
    6 (2 pi^2)^-4 2^8 (1 - 2^-8) zeta(8)."""
    import mpmath
    mpmath.mp.dps = 40
    cgf = (lambda s: mpmath.log(mpmath.cosh(c / 2))
           - mpmath.log(mpmath.cosh(mpmath.sqrt(c * c / 4 - s / 2))))
    want = float(mpmath.re(mpmath.diff(cgf, 0, 4)))
    k4 = glm.pg_cumulant4(torch.tensor(3.0, dtype=F64),
                          torch.tensor(c, dtype=F64))
    assert float(k4) == pytest.approx(3 * want, rel=1e-9)
    if c == 0.0:
        assert want == pytest.approx(96 * 255 / (256 * 9450), rel=1e-12)


def _dense_update(X, omega, kappa, w0, hyp, B, noise):
    """The collapsed update on the full (P, P) Gram of each lane, one
    presyn neuron at a time: an independent formulation of the grouped,
    residual-space update."""
    u_a, eps, z_b = noise
    P, lanes = w0.shape
    N_pre = (P - 1) // B
    J = torch.einsum("tp,tn,tq->npq", X, omega, X)
    h = X.T @ kappa
    w = w0.clone()
    A = torch.zeros((N_pre, lanes), dtype=F64)
    for n in range(lanes):
        for j in range(N_pre):
            s = slice(j * B, (j + 1) * B)
            Jn = J[n]
            m = h[s, n] - Jn[s] @ w[:, n] + Jn[s, s] @ w[s, n]
            Lam, mu0 = hyp["Lam"][j, n], hyp["mu"][j, n]
            Lp = Lam + Jn[s, s]
            Cp = torch.linalg.cholesky(Lp)
            bpost = m + Lam @ mu0
            mu_p = torch.linalg.solve(Lp, bpost)
            log_ev = (0.5 * bpost @ mu_p - 0.5 * mu0 @ Lam @ mu0
                      + 0.5 * torch.logdet(Lam) - 0.5 * torch.logdet(Lp))
            a = bool(u_a.reshape(N_pre, lanes)[j, n]
                     < torch.sigmoid(hyp["lrho"][j, n] + log_ev))
            e = eps.reshape(N_pre, lanes, B)[j, n]
            w[s, n] = (mu_p + torch.linalg.solve_triangular(
                Cp.T, e[:, None], upper=True)[:, 0]) if a else 0.0
            A[j, n] = float(a)
        Jn = J[n]
        m_b = h[-1, n] - (Jn[-1] @ w[:, n] - Jn[-1, -1] * w[-1, n]) \
            + hyp["lam_b"][n] * hyp["mu_b"][n]
        lam_p = hyp["lam_b"][n] + Jn[-1, -1]
        w[-1, n] = m_b / lam_p + z_b[n] / torch.sqrt(lam_p)
    return A, w


def test_spike_slab_equals_the_dense_formulation():
    g = torch.Generator().manual_seed(1)
    N, B, G, T = 4, 2, 2, 400
    Y = (torch.rand((T, N), generator=g) < 0.3).double()
    X = design(Y, B, 5)
    P = N * B + 1
    omega = 0.1 + 0.2 * torch.rand((T, N), generator=g, dtype=F64)
    kappa = Y - 0.5
    w0 = 0.3 * torch.randn((P, N), generator=g, dtype=F64)
    psi = X @ w0
    hyp = {"mu": 0.1 * torch.randn((N, N, B), generator=g, dtype=F64),
           "Lam": torch.eye(B, dtype=F64).expand(N, N, B, B) * 2.0,
           "lrho": torch.randn((N, N), generator=g, dtype=F64),
           "mu_b": torch.full((N,), -2.0, dtype=F64),
           "lam_b": torch.ones((N,), dtype=F64)}
    noise = (torch.rand((N // G, G, N), generator=g, dtype=F64),
             torch.randn((N // G, G, N, B), generator=g, dtype=F64),
             torch.randn((N,), generator=g, dtype=F64))
    A, w = glm.spike_slab(X, omega, kappa, psi, w0, hyp, B, G, noise)
    A2, w2 = _dense_update(X, omega, kappa, w0, hyp, B, noise)
    assert 0 < int(A.sum()) < A.numel()
    assert torch.equal(A, A2)
    torch.testing.assert_close(w, w2, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("a", [0.4, 3.0, 250.0])
def test_gamma_draws_follow_their_law(a):
    g = torch.Generator().manual_seed(2)
    (x, _), *_ = samplers.gamma(torch.full((4000,), a, dtype=F64),
                                g.get_state())
    assert scipy.stats.kstest(x.numpy(),
                              scipy.stats.gamma(a).cdf).pvalue > 1e-3


def test_float32_gamma_draws_are_among_the_references_outcomes():
    """At the weight prior's shapes (a ~ n/2 for n active edges) a float32
    accept test can go the other way from float64's (seed 67 here, on
    the host this was written on): the reference keeps both ways, and the
    program's draw is one of its outcomes on every seed."""
    from pyglm_tpu_torch.ops.linalg import sample_gamma
    alpha = torch.tensor([50000.0, 49999.5, 49999.0, 49998.5])
    for seed in [67] + list(range(300)):
        g = torch.Generator().manual_seed(seed)
        paths = samplers.gamma(alpha, g.get_state())
        prog = sample_gamma(alpha, g).double()
        gaps = [float(((x - prog).abs() / prog).max()) for x, _ in paths]
        assert min(gaps) < 1e-6, (seed, gaps)


def test_er_move_repeats_the_programs_draws():
    from pyglm_tpu_torch.ops.linalg import (niw_posterior, sample_beta,
                                            sample_niw)
    from pyglm_tpu_torch.models.networks import (ErdosRenyiConfig,
                                                 _masked_stats, _niw_params)
    g = torch.Generator().manual_seed(3)
    N, B = 12, 4
    A = (torch.rand((N, N), generator=g) < 0.3).float()
    W = torch.randn((N, N, B), generator=g) * A[..., None]
    prior = {"a_rho": 1.0, "b_rho": 1.0, "niw_mu0": 0.0, "niw_kappa0": 1.0,
             "niw_nu0": 6.0, "niw_psi0": 1.0}
    state = g.get_state()
    ref, *_ = networks.er_resample(prior, {"host_gen": state, "A": A,
                                           "W": W}, B)
    cfg = ErdosRenyiConfig(N=N, B=B)
    g.set_state(state)
    n, xbar, S = _masked_stats(W, A)
    rho = sample_beta(1.0 + n, 1.0 + A.numel() - n, g)
    mu, Sigma = sample_niw(g, niw_posterior(_niw_params(cfg), n, xbar, S))
    for a, b in ((rho, ref["rho"]), (mu, ref["mu"]), (Sigma, ref["Sigma"])):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6)


def test_hmc_leaf_repeats_the_programs_trajectories():
    from pyglm_tpu_torch.models.networks import (HMCNoise,
                                                 LatentDistanceConfig)
    g = torch.Generator().manual_seed(4)
    N, k = 15, 4
    prior = {"sigma_l": 1.0, "sigma_gamma": 2.0, "hmc_eps": 0.15 / N ** 0.5,
             "hmc_steps": 20}
    L0 = torch.randn((1, N, 2), generator=g, dtype=F64)
    g0 = torch.zeros((1,), dtype=F64)
    A = (torch.rand((1, N, N), generator=g) < 0.3).double()
    noise = HMCNoise(torch.randn((1, k, N, 2), generator=g, dtype=F64),
                     torch.randn((1, k), generator=g, dtype=F64),
                     torch.rand((1, k), generator=g, dtype=F64),
                     torch.zeros((1, 0, 2), dtype=torch.long),
                     torch.zeros((1, 0), dtype=F64),
                     torch.zeros((1, 0), dtype=torch.long),
                     torch.zeros((1, 0, 2), dtype=F64),
                     torch.zeros((1, 0), dtype=F64))
    cfg = LatentDistanceConfig(N=N, B=4, hmc_steps=20, hmc_iters=k)
    L1, g1, rate = cfg._hmc(L0, g0, A, noise)
    leaves = networks.hmc_leaves(prior, L0[0], g0[0], A[0], noise.mom_L[0],
                                 noise.mom_gamma[0], noise.u_hmc[0],
                                 round(float(rate[0]) * k), delta=1e-9)
    assert len(leaves) == 1
    torch.testing.assert_close(leaves[0][0], L1[0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(leaves[0][1], g1[0], rtol=1e-10, atol=1e-10)
