"""Kernel K4's algorithm (gamma-series PG(b, c), ``csrc/pg_gamma.cu``)
written out in numpy, on the CPU, where the kernel itself cannot run: the
four series terms and then the tail from one Marsaglia-Tsang proposal
stream (the k-th accepted proposal is term k, the fifth, tried at the
tail's shape, the tail), the proposal normals in Box-Muller pairs, the two
squeezes before the logs (held against the exact test), and the tail sums in the kernel's float32 form
(constant powers of K = 4, reciprocals outside the cancelling branch). The
draws are held against the JAX package's ``pg_gamma_series`` (two-sample
KS, p > 1e-3) and ``pg_mean`` (|z| < 6) on the kernel's grid, and the tail
sums against JAX's ``_tail_sums``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from pyglm_tpu.ops import polyagamma as jp

GRID = [(0.3, 1.0), (1.0, 2.0), (2.5, 0.0), (4.5, 1.0), (13.0, 1.0),
        (40.0, 6.0)]
K = 4


def _mt_stream(shapes, rng):
    """(n, k): per element, the accepted proposals of one Marsaglia-Tsang
    stream, the j-th accepted one tried at shapes[:, j] (each >= 1), two
    proposals per Box-Muller pair, the squeeze tried before the logs."""
    n, n_take = shapes.shape
    d = shapes - 1.0 / 3.0
    cm = 1.0 / np.sqrt(9.0 * d)
    sq = 0.01 / d
    out = np.zeros((n, n_take))
    k = np.zeros(n, dtype=np.int64)
    while (k < n_take).any():
        idx = np.flatnonzero(k < n_take)
        u = 1.0 - rng.random((4, idx.size))                  # (0, 1]
        r = np.sqrt(-2.0 * np.log(u[0]))
        for x, uu in ((r * np.cos(2 * np.pi * u[1]), u[2]),
                      (r * np.sin(2 * np.pi * u[1]), u[3])):
            live = k[idx] < n_take
            kk = np.minimum(k[idx], n_take - 1)
            dd, cc = d[idx, kk], cm[idx, kk]
            acc = (1.0 + cc * x > 0) & (_squeezed(x, uu, dd, cc, sq[idx, kk])
                                        | _log_test(x, uu, dd, cc))
            take = acc & live
            out[idx[take], kk[take]] = dd[take] * (1.0 + cc[take]
                                                    * x[take]) ** 3
            k[idx[take]] += 1
    return out


def _squeezed(x, u, d, c, sq):
    """The two squeezes of csrc/pg_gamma.cu::mt_accept (v0 > 0 assumed)."""
    m = np.minimum(1.0 + c * x, 1.0)
    return (u * m < m - sq * x ** 4) | (u < 1.0 - 0.0331 * x ** 4)


def _log_test(x, u, d, c):
    """Marsaglia and Tsang's exact test (v0 > 0 assumed)."""
    v = np.maximum(1.0 + c * x, 1e-100) ** 3
    return np.log(u) < 0.5 * x * x + d - d * v + d * np.log(v)


def _gammas(shapes, rng):
    """One stream's draws of Gamma(shapes[:, j]), each boosted by
    U^(1/shape) below shape 1."""
    boost = shapes < 1.0
    g = _mt_stream(np.where(boost, shapes + 1.0, shapes), rng)
    u = 1.0 - rng.random(g.shape)
    return g * np.where(boost, u ** (1.0 / shapes), 1.0)


def _tail_sums(a):
    """csrc/pg_gamma.cu::tail_sums in float32."""
    f = np.float32
    a = np.asarray(a, f)
    kK = f(K)
    a2 = a * a
    a4 = a2 * a2
    i1 = f(1) / (kK * kK + a2)
    i2 = i1 * i1
    small = a < f(0.5)
    aK2 = a2 * f(1 / 16)
    t1s = (f(1) - aK2 * f(1 / 3) + aK2 * aK2 * f(1 / 5)) * f(1 / 4)
    t2s = f(1 / 192) - a2 * f(2 / 5120) + a4 * f(3 / (7 * 16384))
    t3s = f(1 / 5120) - a2 * f(3 / (7 * 16384)) + a4 * f(2 / (3 * 262144))
    with np.errstate(divide="ignore", invalid="ignore"):
        # atan rounded once from float64 (numpy's float32 atan is off by
        # ulps that S3's cancellation turns into 1e-3).
        at = np.arctan(a.astype(np.float64) / 4).astype(f)
        dK = kK * kK + a2
        t1b = at / a
        t2b = at / (f(2) * (a * a2)) - kK / (f(2) * a2 * dK)
        t3b = (f(3) * at / (f(8) * (a * a4)) - kK / (f(4) * a2 * dK * dK)
               - f(3) * kK / (f(8) * a4 * dK))
    t1, t2, t3 = (np.where(small, s, b) for s, b in
                  ((t1s, t1b), (t2s, t2b), (t3s, t3b)))
    return (t1 - f(8 / 24) * i2, t2 - f(16 / 24) * (i2 * i1),
            t3 - f(24 / 24) * (i2 * i2))


def _series(b, c, rng):
    """PG(b, c) by K4's algorithm (the series regime), float64 draws: the
    four terms and then the tail from one proposal stream."""
    bp = np.maximum(b, 1e-6)
    a = np.abs(c) / (2 * np.pi)
    S1, S2, S3 = (x.astype(np.float64) for x in _tail_sums(a))
    tpp = 2 * np.pi ** 2
    m_t, v_t = bp * S1 / tpp, bp * S2 / (4 * np.pi ** 4)
    mu3 = 2 * bp * S3 / tpp ** 3
    beta = 2 * v_t / np.maximum(mu3, 1e-30)
    alpha = v_t * beta * beta
    delta = np.maximum(m_t - alpha / beta, 0.0)
    g = _gammas(np.stack([bp] * K + [alpha], axis=1), rng)
    s = (g[:, :K] / ((np.arange(K) + 0.5) ** 2 + a[:, None] ** 2)).sum(1)
    return s / tpp + delta + g[:, K] / beta


@pytest.mark.parametrize("b,c", GRID)
def test_shared_stream_law_matches_jax(b, c):
    n = 50_000
    rng = np.random.default_rng(int(b * 100 + c) + 3)
    ours = _series(np.full(n, b), np.full(n, c), rng)
    ref = np.asarray(jp.pg_gamma_series(jax.random.key(int(b * 100 + c)),
                                        jnp.full((n,), b, jnp.float32),
                                        jnp.full((n,), c, jnp.float32)))
    assert np.isfinite(ours).all() and (ours > 0).all()
    assert scipy.stats.ks_2samp(ours, ref).pvalue > 1e-3
    m, v = float(jp.pg_mean(b, c)), float(jp.pg_var(b, c))
    assert abs(ours.mean() - m) < 6 * math.sqrt(v / n)


def test_shared_stream_draws_are_independent_gammas():
    """The k-th accepted proposal of one stream, for k = 1..4 at one shape
    and then a fifth at another, follows its Gamma law, and the five are
    uncorrelated."""
    rng = np.random.default_rng(7)
    for shape, tail in ((1.3, 5.2), (4.0, 15.9), (19.0, 75.5), (4.0, 1.0)):
        shapes = np.array([shape] * K + [tail])
        g = _mt_stream(np.tile(shapes, (40_000, 1)), rng)
        for k in range(K + 1):
            assert scipy.stats.kstest(g[:, k], "gamma",
                                      args=(shapes[k],)).pvalue > 1e-3
        cor = np.corrcoef(g.T)[np.triu_indices(K + 1, 1)]
        assert np.abs(cor).max() < 6 / math.sqrt(g.shape[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_squeezes_accept_only_what_the_log_test_accepts(dtype):
    """At every shape the kernel draws at (>= 1, so d >= 2/3), with the
    squeezes evaluated in float64 and in the kernel's float32, on normal
    proposals and on uniforms just inside the tighter squeeze's boundary:
    no proposal a squeeze accepts fails the exact log test (in float64)."""
    rng = np.random.default_rng(11)
    for shape in (1.0, 1.3, 4.0, 5.2, 19.0, 75.5, 1e3, 1e5):
        d = shape - 1.0 / 3.0
        c, sq = 1.0 / np.sqrt(9.0 * d), 0.01 / d
        x = np.concatenate([rng.standard_normal(400_000),
                            np.linspace(-1.0 / c + 1e-6, 12.0, 200_001)])
        x = x[1.0 + c * x > 0]
        m = np.minimum(1.0 + c * x, 1.0)
        for u in (rng.random(x.size),
                  np.clip((m - sq * x ** 4) / m * (1 - 1e-7), 1e-12, 1.0)):
            f = dtype
            hit = _squeezed(x.astype(f), u.astype(f), f(d), f(c), f(sq))
            assert not np.any(hit & ~_log_test(x, u, d, c))


def test_tail_sums_match_jax():
    """The kernel's float32 form against JAX's _tail_sums: rtol 2e-5,
    except S3 on 0.5 <= a < 2.1, where the exact forms cancel (S3 by ~1e4
    at a = 0.5) and rounding shows at rtol 1e-3, as between the two
    packages' own plain forms (tests/test_torch_pg_gamma.py)."""
    rng = np.random.default_rng(0)
    a = np.concatenate([[0.0, 1e-6, 0.1, 0.49, 0.499, 0.5, 0.51, 1.0, 5.0,
                         50.0, 300.0], rng.uniform(0, 10, 200),
                        np.linspace(0.5, 2.1, 500)]).astype(np.float32)
    band = (a >= 0.5) & (a < 2.1)
    got = _tail_sums(a)
    ref = jp._tail_sums(jnp.asarray(a), K)
    for g, r, rtol_band in zip(got, ref, (2e-5, 2e-5, 1e-3)):
        r = np.asarray(r)
        np.testing.assert_allclose(g[~band], r[~band], rtol=2e-5, atol=0)
        np.testing.assert_allclose(g[band], r[band], rtol=rtol_band, atol=0)
