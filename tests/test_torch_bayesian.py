"""The conjugate building blocks of pyglm_tpu_torch (models/bayesian.py:
Gaussian, Regression, DiagonalRegression; models/abstractions.py) on the
CPU.

- Each log-likelihood against the JAX package's at the same parameters
  (rtol 1e-5); the contract of the abstractions.
- The prior draw of the NIW Gaussian: the prior's mean and the variance
  of mu (rtol 0.5, as tests/test_bayesian.py); the MNIW regression
  recovers a linear map (atol 0.05, as there).
- Slow, as in the JAX package: the NIW posterior concentrates, the
  diagonal regression recovers its map and variances.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu.models import bayesian as jb
from pyglm_tpu_torch import SparseBernoulliGLM
from pyglm_tpu_torch.models import bayesian as tb
from pyglm_tpu_torch.models.abstractions import (
    GibbsSampling, ModelGibbsSampling,
)

torch.set_num_threads(1)


def test_log_likelihoods_match_jax():
    rng = np.random.RandomState(0)
    g, gj = tb.Gaussian(D=3, seed=1, device="cpu"), jb.Gaussian(D=3, seed=1)
    g.mu, g.sigma = gj.mu.copy(), gj.sigma.copy()
    x = rng.randn(6, 3)
    np.testing.assert_allclose(g.log_likelihood(x), gj.log_likelihood(x),
                               rtol=1e-5)
    X, Y = rng.randn(5, 2), rng.randn(5, 3)
    for cls in ("Regression", "DiagonalRegression"):
        r = getattr(tb, cls)(3, 2, seed=0, device="cpu")
        rj = getattr(jb, cls)(3, 2, seed=0)
        r.A = rj.A.copy()
        for f in ("sigma", "sigmasq"):
            if hasattr(rj, f):
                setattr(r, f, getattr(rj, f).copy())
        np.testing.assert_allclose(r.log_likelihood((X, Y)),
                                   rj.log_likelihood((X, Y)), rtol=1e-5)
        assert r.rvs(X).shape == (5, 3)


def test_abstractions_contract():
    assert isinstance(tb.Gaussian(D=2, device="cpu"), GibbsSampling)
    assert isinstance(tb.Regression(2, 2, device="cpu"), GibbsSampling)
    m = SparseBernoulliGLM(3, B=2, L=3, device="cpu")
    for name in ("add_data", "generate", "resample_model", "log_likelihood"):
        assert callable(getattr(m, name))
    with pytest.raises(TypeError):
        ModelGibbsSampling()


def test_gaussian_prior_resample_matches_prior():
    g = tb.Gaussian(D=2, kappa_0=2.0, nu_0=6.0, seed=2, device="cpu")
    mus = []
    for _ in range(300):
        g.resample(None)
        mus.append(g.mu.copy())
    mus = np.asarray(mus)
    # mu | Sigma ~ N(0, Sigma / 2), Sigma ~ IW(6, I): E[Sigma] = I / 3.
    assert abs(mus.mean()) < 0.1
    np.testing.assert_allclose(mus.var(0), 1 / 3 / 2, rtol=0.5)


def test_regression_recovers_linear_map():
    rng = np.random.RandomState(1)
    A_true = np.array([[2.0, -1.0], [0.5, 1.5]])
    b_true = np.array([0.3, -0.7])
    X = rng.randn(3000, 2)
    Y = X @ A_true.T + b_true + 0.1 * rng.randn(3000, 2)
    reg = tb.Regression(D_out=2, D_in=2, seed=0, device="cpu")
    As = []
    for _ in range(40):
        reg.resample((X, Y))
        As.append(reg.A.copy())
    A_hat = np.mean(As[10:], axis=0)
    np.testing.assert_allclose(A_hat[:, :2], A_true, atol=0.05)
    np.testing.assert_allclose(A_hat[:, 2], b_true, atol=0.05)
    np.testing.assert_allclose(np.diag(reg.sigma), [0.01, 0.01], rtol=0.5)
    Yp = reg.rvs(X[:100])
    assert np.abs(Yp - (X[:100] @ A_true.T + b_true)).mean() < 0.5
    ll = reg.log_likelihood((X[:3], Y[:3]))
    assert np.all(np.isfinite(ll)) and ll.shape == (3,)


@pytest.mark.slow
def test_gaussian_posterior_concentrates():
    rng = np.random.RandomState(0)
    X = rng.randn(2000, 2) * [0.5, 2.0] + [1.0, -3.0]
    g = tb.Gaussian(D=2, seed=1, device="cpu")
    mus, sigs = [], []
    for _ in range(50):
        g.resample(X)
        mus.append(g.mu)
        sigs.append(g.sigma)
    np.testing.assert_allclose(np.mean(mus[10:], axis=0), [1.0, -3.0],
                               atol=0.15)
    np.testing.assert_allclose(np.diag(np.mean(sigs[10:], axis=0)),
                               [0.25, 4.0], rtol=0.2)
    from scipy.stats import multivariate_normal
    np.testing.assert_allclose(
        g.log_likelihood(X[:5]),
        multivariate_normal.logpdf(X[:5], g.mu, g.sigma), rtol=1e-3,
        atol=1e-3)
    s = g.rvs(20000)
    np.testing.assert_allclose(s.mean(0), g.mu, atol=4 * np.sqrt(
        np.diag(g.sigma).max() / 20000) + 0.05)


@pytest.mark.slow
def test_diagonal_regression():
    rng = np.random.RandomState(3)
    X = rng.randn(2000, 3)
    A_true = np.array([[1.0, -0.5, 2.0], [0.0, 1.0, -1.0]])
    Y = X @ A_true.T + [0.5, -0.5] + rng.randn(2000, 2) * [0.3, 1.0]
    reg = tb.DiagonalRegression(D_out=2, D_in=3, seed=0, device="cpu")
    As, s2s = [], []
    for _ in range(40):
        reg.resample((X, Y))
        As.append(reg.A.copy())
        s2s.append(reg.sigmasq.copy())
    A_hat = np.mean(As[10:], 0)
    np.testing.assert_allclose(A_hat[:, :3], A_true, atol=0.1)
    np.testing.assert_allclose(A_hat[:, 3], [0.5, -0.5], atol=0.1)
    np.testing.assert_allclose(np.mean(s2s[10:], 0), [0.09, 1.0], rtol=0.3)
    ll = reg.log_likelihood((X[:4], Y[:4]))
    assert ll.shape == (4,) and np.all(np.isfinite(ll))
    assert reg.rvs(X[:5]).shape == (5, 2)
