"""pyglm_tpu_torch.ops.linalg: the unrolled small-B factorizations and the
NIW posterior against the JAX package (random SPD B=4 stacks, rtol 1e-5),
the Wishart-family samplers against closed-form means (within 4 standard
errors), and the Marsaglia-Tsang gamma sampler by KS test against
scipy.stats.gamma (p > 1e-3)."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from pyglm_tpu.ops import linalg as jl
from pyglm_tpu_torch.ops import linalg as tl

torch.set_num_threads(1)
RTOL = 1e-5


def _spd(seed, batch=(7, 5), B=4):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal(batch + (B, B))
    return (M @ np.swapaxes(M, -1, -2) + B * np.eye(B)).astype(np.float32)


def test_chol_small_matches_jax():
    A = _spd(0)
    got = tl.chol_small(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.chol_small(jnp.asarray(A))),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2), A, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["solve_lower_small", "solve_lower_t_small"])
def test_triangular_solves_match_jax(fn):
    A = _spd(1)
    b = np.random.default_rng(2).standard_normal(A.shape[:-1]).astype(
        np.float32)
    Lj = jl.chol_small(jnp.asarray(A))
    ref = np.asarray(getattr(jl, fn)(Lj, jnp.asarray(b)))
    got = getattr(tl, fn)(torch.tensor(np.asarray(Lj)),
                          torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


def test_large_b_falls_back_to_linalg():
    A = _spd(3, batch=(3,), B=10)
    L = tl.chol_small(torch.from_numpy(A))
    b = torch.ones(3, 10)
    x = tl.solve_lower_small(L, b)
    np.testing.assert_allclose((L @ x[..., None])[..., 0].numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("n", [0.0, 37.0])
def test_niw_posterior_matches_jax(n):
    rng = np.random.default_rng(4)
    B = 4
    mu0 = rng.standard_normal(B).astype(np.float32)
    Psi0 = _spd(5, batch=())
    xbar = rng.standard_normal(B).astype(np.float32)
    S = _spd(6, batch=())
    pj = jl.NIWParams(jnp.asarray(mu0), jnp.float32(2.0), jnp.float32(7.0),
                      jnp.asarray(Psi0))
    pt = tl.NIWParams(torch.from_numpy(mu0), torch.tensor(2.0),
                      torch.tensor(7.0), torch.from_numpy(Psi0))
    ref = jl.niw_posterior(pj, n, jnp.asarray(xbar), jnp.asarray(S))
    got = tl.niw_posterior(pt, n, torch.from_numpy(xbar), torch.from_numpy(S))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, 40.0])
def test_gamma_sampler_ks(alpha):
    gen = torch.Generator().manual_seed(int(alpha * 10))
    x = tl.sample_gamma(torch.full((20_000,), alpha), gen).numpy()
    assert np.all(x > 0)
    assert scipy.stats.kstest(x, scipy.stats.gamma(alpha).cdf).pvalue > 1e-3


def test_beta_sampler_mean():
    gen = torch.Generator().manual_seed(0)
    x = tl.sample_beta(torch.full((20_000,), 3.0), torch.full((20_000,), 5.0),
                       gen).numpy()
    assert scipy.stats.kstest(x, scipy.stats.beta(3.0, 5.0).cdf).pvalue > 1e-3


def _mean_within(samples, expected, k=4.0):
    se = samples.std(axis=0) / np.sqrt(samples.shape[0])
    assert np.all(np.abs(samples.mean(axis=0) - expected) <= k * se + 1e-6), (
        samples.mean(axis=0), expected)


def test_sample_invwishart_mean():
    B, nu = 4, 9.0
    Psi = torch.from_numpy(_spd(7, batch=()))
    gen = torch.Generator().manual_seed(1)
    draws = np.stack([tl.sample_invwishart(gen, nu, Psi).numpy()
                      for _ in range(3000)])
    _mean_within(draws, Psi.numpy() / (nu - B - 1))


def test_sample_niw_means():
    B = 4
    p = tl.NIWParams(torch.tensor([0.5, -1.0, 0.0, 2.0]), torch.tensor(2.0),
                     torch.tensor(10.0), torch.from_numpy(_spd(8, batch=())))
    gen = torch.Generator().manual_seed(2)
    mus, sigmas = zip(*(tl.sample_niw(gen, p) for _ in range(3000)))
    _mean_within(np.stack([m.numpy() for m in mus]), p.mu0.numpy())
    _mean_within(np.stack([s.numpy() for s in sigmas]),
                 p.Psi0.numpy() / (float(p.nu0) - B - 1))
