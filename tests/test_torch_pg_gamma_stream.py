"""Kernel K4's algorithm (gamma-series PG(b, c), ``csrc/pg_gamma.cu``)
written out in numpy, on the CPU, where the kernel itself cannot run: the
four series terms and then the tail from one Marsaglia-Tsang proposal
stream (the k-th accepted proposal is term k, the fifth, tried at the
tail's shape, the tail), the proposal normals in Box-Muller pairs, the two
squeezes before the logs (held against the exact test), and the tail sums in the kernel's float32 form
(constant powers of K = 4, reciprocals outside the cancelling branch). The
draws are held against the JAX package's ``pg_gamma_series`` (two-sample
KS, p > 1e-3) and ``pg_mean`` (|z| < 6) on the kernel's grid, and the tail
sums against JAX's ``_tail_sums``.

Also the run-time body (``gamma_series<kRunTimeK>``) at K terms, element
by element in the order of its Philox calls: a boosted series' first call
before the proposals, one call a round (two proposals), a refill call
whenever four boost words are spent, the tail's boost call last; the tail
sums at run-time powers of K' = max(K, 4), the terms K < k <= 4 added
exactly. Its law is held against JAX's ``pg_gamma_series(..., K=K)`` at K =
1, 2 and 8 (against JAX's K = 4 where JAX's K = 1 draws are +inf), its
Philox calls are counted, and its tail sums are held against the K = 4
constant form and the plain version's."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pyglm_tpu.ops import polyagamma as jp
from pyglm_tpu_torch.ops import polyagamma as tp

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


def _tail_sums_k(a, K):
    """csrc/pg_gamma.cu::tail_k and tail_sums_k in float32: tail_sums'
    formulas at K' = max(K, 4), their constants computed as tail_k does,
    the Taylor branch below a = K'/8, then the terms K < k <= 4."""
    f = np.float32
    a = np.asarray(a, f)
    kK = f(max(K, K_BODY))
    kK3 = kK * kK * kK
    kK5 = kK3 * kK * kK
    kK7 = kK5 * kK * kK
    kK9 = kK7 * kK * kK
    a2 = a * a
    a4 = a2 * a2
    i1 = f(1) / (kK * kK + a2)
    i2 = i1 * i1
    small = a < f(0.125) * kK
    aK2 = a2 * (f(1) / (kK * kK))
    t1s = (f(1) - aK2 * f(1 / 3) + aK2 * aK2 * f(1 / 5)) * (f(1) / kK)
    t2s = (f(1) / (f(3) * kK3) - a2 * (f(2) / (f(5) * kK5))
           + a4 * (f(3) / (f(7) * kK7)))
    t3s = (f(1) / (f(5) * kK5) - a2 * (f(3) / (f(7) * kK7))
           + a4 * (f(2) / (f(3) * kK9)))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        at = np.arctan(a.astype(np.float64) / kK).astype(f)
        dK = kK * kK + a2
        t1b = at / a
        t2b = at / (f(2) * (a * a2)) - kK / (f(2) * a2 * dK)
        t3b = (f(3) * at / (f(8) * (a * a4)) - kK / (f(4) * a2 * dK * dK)
               - f(3) * kK / (f(8) * a4 * dK))
    t1, t2, t3 = (np.where(small, s, b) for s, b in
                  ((t1s, t1b), (t2s, t2b), (t3s, t3b)))
    S1 = t1 - (f(2) * kK / f(24)) * i2
    S2 = t2 - (f(4) * kK / f(24)) * (i2 * i1)
    S3 = t3 - (f(6) * kK / f(24)) * (i2 * i2)
    for k in range(K_BODY, K, -1):
        h = f(k) - f(0.5)
        w = f(1) / (h * h + a2)
        S1, S2, S3 = S1 + w, S2 + w * w, S3 + w * w * w
    return S1, S2, S3


K_BODY = 4          # the four-term body's K: kTerms of csrc/pg_gamma.cu


def _run_time_body(b, c, K, rng):
    """PG(b, c) by K4's run-time body (the series regime), float64 draws,
    element by element in the order of its Philox calls, each call four
    uniforms in (0, 1]. Returns (draws, Philox calls, rounds) per
    element."""
    n = b.size
    bp = np.maximum(b, 1e-6)
    a = np.abs(c) / (2 * np.pi)
    S1, S2, S3 = (x.astype(np.float64) for x in _tail_sums_k(a, K))
    tpp = 2 * np.pi ** 2
    m_t, v_t = bp * S1 / tpp, bp * S2 / (4 * np.pi ** 4)
    mu3 = 2 * bp * S3 / tpp ** 3
    beta = 2 * v_t / np.maximum(mu3, 1e-30)
    alpha = v_t * beta * beta
    delta = np.maximum(m_t - alpha / beta, 0.0)
    boost_s, boost_t = bp < 1.0, alpha < 1.0
    shapes = [np.where(boost_s, bp + 1, bp), np.where(boost_t, alpha + 1,
                                                       alpha)]
    d = [x - 1.0 / 3.0 for x in shapes]
    cm = [1.0 / np.sqrt(9.0 * x) for x in d]
    sq = [0.01 / x for x in d]
    calls = np.zeros(n, np.int64)
    rounds = np.zeros(n, np.int64)

    def call(idx):
        calls[idx] += 1
        return 1.0 - rng.random((idx.size, 4))

    words = np.zeros((n, 4))
    left = np.zeros(n, np.int64)          # boost words left in a call
    first = np.flatnonzero(boost_s)
    words[first], left[first] = call(first), 4
    s, g_tail = np.zeros(n), np.zeros(n)
    k = np.zeros(n, np.int64)             # accepted: terms, then the tail

    def take(idx, g):                     # idx: distinct elements
        bo = idx[boost_s[idx]]
        empty = bo[left[bo] == 0]
        words[empty], left[empty] = call(empty), 4
        u = np.ones(idx.size)
        u[boost_s[idx]] = words[bo, 4 - left[bo]]
        left[bo] -= 1
        g = g * u ** np.where(boost_s[idx], 1.0 / bp[idx], 0.0)
        s[idx] += g / ((k[idx] + 0.5) ** 2 + a[idx] ** 2)
        k[idx] += 1

    while (k <= K).any():
        idx = np.flatnonzero(k <= K)
        rounds[idx] += 1
        w = call(idx)
        r = np.sqrt(-2.0 * np.log(w[:, 0]))
        for x, u in ((r * np.cos(2 * np.pi * w[:, 1]), w[:, 2]),
                     (r * np.sin(2 * np.pi * w[:, 1]), w[:, 3])):
            live, tail = k[idx] <= K, k[idx] == K
            dd, cc, ss = (np.where(tail, p[1][idx], p[0][idx])
                          for p in (d, cm, sq))
            acc = live & (1.0 + cc * x > 0) & (_squeezed(x, u, dd, cc, ss)
                                               | _log_test(x, u, dd, cc))
            v = dd * np.maximum(1.0 + cc * x, 0.0) ** 3
            done = idx[acc & tail]
            g_tail[done] = v[acc & tail]
            k[done] += 1
            take(idx[acc & ~tail], v[acc & ~tail])
    bt = np.flatnonzero(boost_t)
    g_tail[bt] *= call(bt)[:, 0] ** (1.0 / alpha[bt])
    return s / tpp + delta + g_tail / beta, calls, rounds


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("b,c", [(0.3, 1.0), (4.5, 1.0), (40.0, 6.0)])
def test_run_time_body_law_matches_jax(K, b, c):
    """At (0.3, 1) every term is boosted, so at K = 8 the words refill
    once. JAX's K = 1 draws are +inf where a <= 0.35 (its S3 < 0); there
    the reference is the port's plain version at K = 1 (its tail sums held
    to float64 sums in tests/test_torch_pg_gamma.py)."""
    n = 25_000
    rng = np.random.default_rng(int(b * 100 + c) + 31 * K)
    ours, calls, rounds = _run_time_body(np.full(n, b), np.full(n, c), K,
                                         rng)
    args = (jax.random.key(int(b * 100 + c) + 5 * K),
            jnp.full((n,), b, jnp.float32), jnp.full((n,), c, jnp.float32))
    ref = np.asarray(jp.pg_gamma_series(*args, K=K))
    if K == 1 and c < 3.0:
        assert np.isposinf(ref).all()
        ref = tp.pg_gamma_series_plain(
            torch.full((n,), b), torch.full((n,), c),
            torch.Generator().manual_seed(int(b * 100 + c)), K=K).numpy()
    assert np.isfinite(ours).all() and (ours > 0).all()
    assert scipy.stats.ks_2samp(ours, ref).pvalue > 1e-3
    m, v = float(jp.pg_mean(b, c)), float(jp.pg_var(b, c))
    assert abs(ours.mean() - m) < 6 * math.sqrt(v / n)
    # One call a round, one per four boosted terms (b < 1: every term),
    # one for a boosted tail.
    boosts = -(-K // 4) if b < 1.0 else 0
    tail_boosts = calls - rounds - boosts
    assert set(np.unique(tail_boosts)) <= {0, 1}


def test_run_time_tail_sums_equal_the_four_term_form_at_four():
    """At K = 4 the run-time form is the constant form (rtol 2e-7: the
    constants 1/192 ... are the same float32 values)."""
    a = np.concatenate([np.linspace(0.0, 3.0, 301),
                        np.geomspace(3.0, 300.0, 50)]).astype(np.float32)
    for g, r in zip(_tail_sums_k(a, 4), _tail_sums(a)):
        np.testing.assert_allclose(g, r, rtol=2e-7, atol=0)


@pytest.mark.parametrize("K", [1, 2, 8, 64])
def test_run_time_tail_sums_match_the_plain_version(K):
    """The kernel's run-time form against the plain version's _tail_sums
    at K, the same formulas: rtol 2e-5, and 1e-3 for S3 where the exact
    branch cancels (a in [K'/8, 4.2 K'/8), K' = max(K, 4))."""
    rng = np.random.default_rng(1)
    Kp = max(K, 4)
    a = np.concatenate([[0.0, 1e-6, 0.1, 0.49, 0.5, 1.0, 5.0, 300.0],
                        rng.uniform(0, 10, 200),
                        np.linspace(Kp / 8, 4.2 * Kp / 8, 200),
                        np.geomspace(1.0, 300.0, 50)]).astype(np.float32)
    band = (a >= Kp / 8) & (a < 4.2 * Kp / 8)
    got = _tail_sums_k(a, K)
    ref = tp._tail_sums(torch.from_numpy(a), K)
    for g, r, rtol_band in zip(got, ref, (2e-5, 2e-5, 1e-3)):
        r = r.numpy()
        np.testing.assert_allclose(g[~band], r[~band], rtol=2e-5, atol=0)
        np.testing.assert_allclose(g[band], r[band], rtol=rtol_band, atol=0)
