"""The standalone PG regressions of pyglm_tpu_torch (models/regressions.py)
against the JAX package on the CPU.

- posterior_info: J and h against JAX's per-output formula on the same
  omega and kappa (max |diff| / max |J| below 1e-5: fp32 sums in another
  order); the weight draw on the same standard normals (JAX's own, drawn
  from its per-output keys) within 1e-4 of max |w|.
- Each class's log-likelihood against JAX's at the same A and b (rtol
  1e-5), and one resample (shapes, finite values; NB's r moves and stays
  >= 1e-3); rvs's shapes and supports.
- Slow, as in the JAX package: the recoveries of tests/test_regressions.py
  and the multinomial chain against the port's copy of
  NumpyMultinomialRegression with the gates of
  tests/test_numpy_parity.py:504-557.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.models import regressions as jr
from pyglm_tpu_torch.models import regressions as tr
from pyglm_tpu_torch.reference.numpy_ref import NumpyMultinomialRegression

torch.set_num_threads(1)


def _inputs(T=700, D_in=5, D_out=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((T, D_in)).astype(np.float32)
    omega = rng.uniform(0.05, 0.4, (T, D_out)).astype(np.float32)
    kappa = (rng.integers(0, 2, (T, D_out)) - 0.5).astype(np.float32)
    mu = (0.1 * rng.standard_normal((D_out, D_in + 1))).astype(np.float32)
    lam = rng.uniform(0.5, 2.0, (D_out, D_in + 1)).astype(np.float32)
    return X, kappa, omega, mu, lam


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_posterior_info_matches_jax():
    X, kappa, omega, mu, lam = _inputs()
    J, h = tr.posterior_info(*_t(X, kappa, omega, mu, lam))
    Xb = jnp.concatenate([X, jnp.ones((X.shape[0], 1))], axis=1)
    for d in range(omega.shape[1]):
        Jd = (Xb * omega[:, d][:, None]).T @ Xb + jnp.diag(lam[d])
        hd = Xb.T @ kappa[:, d] + lam[d] * mu[d]
        Jd, hd = np.asarray(Jd), np.asarray(hd)
        assert np.abs(J[d].numpy() - Jd).max() / np.abs(Jd).max() < 1e-5
        assert np.abs(h[d].numpy() - hd).max() / np.abs(hd).max() < 1e-5


def test_weight_draw_matches_jax_on_the_same_normals():
    X, kappa, omega, mu, lam = _inputs(seed=1)
    key = jax.random.key(4)
    ref = np.asarray(jr._resample_weights(
        key, jnp.asarray(X), jnp.asarray(kappa), jnp.asarray(omega),
        jnp.asarray(mu), jnp.asarray(lam)))
    keys = jax.random.split(key, omega.shape[1])
    eps = np.stack([np.asarray(jax.random.normal(k, (X.shape[1] + 1,)))
                    for k in keys])
    got = tr.resample_weights(None, *_t(X, kappa, omega, mu, lam),
                              eps=torch.from_numpy(eps)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def _pair(name, D_out=2, D_in=3):
    if name == "bernoulli":
        return (jr.BernoulliRegression(D_out, D_in, seed=0),
                tr.BernoulliRegression(D_out, D_in, seed=0, device="cpu"))
    if name == "binomial":
        return (jr.BinomialRegression(4, D_out, D_in, seed=0),
                tr.BinomialRegression(4, D_out, D_in, seed=0, device="cpu"))
    if name == "negative_binomial":
        kw = dict(r=3.0, max_y=64, sigmasq_A=0.01, mu_b=-1.0,
                  sigmasq_b=0.01, seed=0)
        return (jr.NegativeBinomialRegression(D_out, D_in, **kw),
                tr.NegativeBinomialRegression(D_out, D_in, device="cpu",
                                              **kw))
    return (jr.MultinomialRegression(D_out + 1, D_in, seed=0),
            tr.MultinomialRegression(D_out + 1, D_in, seed=0, device="cpu"))


@pytest.mark.parametrize("name", ["bernoulli", "binomial",
                                  "negative_binomial", "multinomial"])
def test_regression_matches_jax_and_resamples(name):
    jreg, treg = _pair(name)
    rng = np.random.default_rng(2)
    X = rng.standard_normal((400, 3)).astype(np.float32)
    treg.A, treg.b = jreg.A.copy(), jreg.b.copy()
    if name == "multinomial":
        y = treg.rvs(X, n_trials=3)
        assert y.shape == (400, 3) and np.all(y.sum(-1) == 3)
    else:
        y = treg.rvs(X)
        assert y.shape == (400, 2) and np.all(y >= 0)
    np.testing.assert_allclose(treg.log_likelihood((X, y)),
                               jreg.log_likelihood((X, y)), rtol=1e-5,
                               atol=1e-4)
    if name == "multinomial":
        np.testing.assert_allclose(treg.pi(X), np.asarray(jreg.pi(X)),
                                   rtol=1e-5, atol=1e-6)
    r0 = getattr(treg, "r", None)
    A0 = treg.A.copy()
    treg.resample([(X, y)])
    assert treg.A.shape == A0.shape and treg.b.shape == (A0.shape[0],)
    assert np.isfinite(treg.A).all() and not np.array_equal(treg.A, A0)
    if r0 is not None:
        assert not np.array_equal(treg.r, r0) and np.all(treg.r >= 1e-3)


def _fit(reg, X, y, n=60):
    lls = []
    for _ in range(n):
        reg.resample([(X, y)])
        lls.append(float(np.sum(reg.log_likelihood((X, y)))))
    return lls


@pytest.mark.slow
def test_bernoulli_regression_recovers_weights():
    rng = np.random.RandomState(0)
    T, D = 4000, 3
    X = rng.randn(T, D).astype(np.float32)
    A_true = np.array([[1.5, -1.0, 0.5]], np.float32)
    psi = X @ A_true.T + 0.3
    y = (rng.rand(T, 1) < 1 / (1 + np.exp(-psi))).astype(np.float32)
    reg = tr.BernoulliRegression(1, D, seed=1, device="cpu")
    _fit(reg, X, y, 40)
    A_avg = np.zeros_like(A_true)
    for _ in range(20):
        reg.resample([(X, y)])
        A_avg += reg.A / 20
    np.testing.assert_allclose(A_avg, A_true, atol=0.3)


@pytest.mark.slow
def test_binomial_regression_runs():
    rng = np.random.RandomState(1)
    X = rng.randn(800, 2).astype(np.float32)
    y = tr.BinomialRegression(10, 1, 2, seed=0, device="cpu").rvs(X)
    assert y.shape == (800, 1) and y.max() <= 10
    reg = tr.BinomialRegression(10, 1, 2, seed=3, device="cpu")
    lls = _fit(reg, X, y, 30)
    assert lls[-1] > lls[0]


@pytest.mark.slow
def test_nb_regression_r_recovery():
    X = np.zeros((4000, 1), np.float32)
    true = tr.NegativeBinomialRegression(1, 1, r=7.0, resample_r=False,
                                         seed=0, device="cpu")
    true.A[:] = 0.0
    true.b[:] = -0.3
    y = true.rvs(X)
    reg = tr.NegativeBinomialRegression(1, 1, r=2.0, max_y=int(y.max()) + 1,
                                        seed=5, device="cpu")
    for _ in range(40):
        reg.resample([(X, y)])
    # r and b are identified jointly, through the mean r e^b and the shape.
    mean_est = reg.r[0] * np.exp(reg.b[0])
    mean_true = 7.0 * np.exp(-0.3)
    assert abs(mean_est - mean_true) / mean_true < 0.2
    assert 1.0 < reg.r[0] < 40.0


@pytest.mark.slow
def test_multinomial_regression():
    rng = np.random.RandomState(3)
    T, D, K = 3000, 2, 4
    X = rng.randn(T, D).astype(np.float32)
    y = tr.MultinomialRegression(K, D, seed=0, device="cpu").rvs(X,
                                                                 n_trials=5)
    assert y.shape == (T, K)
    np.testing.assert_allclose(y.sum(-1), 5.0)
    reg = tr.MultinomialRegression(K, D, seed=9, device="cpu")
    lls = _fit(reg, X, y, 40)
    assert np.mean(lls[-5:]) > lls[0]
    np.testing.assert_allclose(reg.pi(X).sum(-1), 1.0, atol=1e-5)


@pytest.mark.slow
def test_multinomial_posterior_matches_numpy_oracle():
    """The port's chain against the port's copy of the f64 oracle, whose
    integer-b PG draws are exact N_k-fold Devroye convolutions: the
    protocol and gates of tests/test_numpy_parity.py:504-557."""
    K, D_in, T, n_trials = 4, 3, 600, 5
    rng = np.random.RandomState(5)
    X = rng.randn(T, D_in).astype(np.float64)
    planted = tr.MultinomialRegression(K, D_in, seed=42, device="cpu")
    Y = np.asarray(planted.rvs(X, n_trials=n_trials), np.float64)
    assert Y.sum(-1).max() == n_trials
    n_burn, n_keep = 100, 400

    reg = tr.MultinomialRegression(K, D_in, seed=0, device="cpu")
    A1 = np.zeros((K - 1, D_in)); b1 = np.zeros(K - 1)
    pi1 = np.zeros((T, K))
    for it in range(n_burn + n_keep):
        reg.resample((X, Y))
        if it >= n_burn:
            A1 += reg.A / n_keep
            b1 += reg.b / n_keep
            pi1 += reg.pi(X) / n_keep

    ref = NumpyMultinomialRegression(K, D_in, seed=7)
    A2 = np.zeros((K - 1, D_in)); b2 = np.zeros(K - 1)
    pi2 = np.zeros((T, K))
    for it in range(n_burn + n_keep):
        ref.resample(X, Y)
        if it >= n_burn:
            A2 += ref.A / n_keep
            b2 += ref.b / n_keep
            pi2 += ref.pi(X) / n_keep

    assert np.max(np.abs(A1 - A2)) < 0.1, (A1, A2)
    assert np.max(np.abs(b1 - b2)) < 0.1, (b1, b2)
    assert np.max(np.abs(pi1 - pi2)) < 0.03, np.max(np.abs(pi1 - pi2))
    assert np.allclose(pi1.sum(-1), 1.0, atol=1e-4)
