"""pyglm_tpu_torch's general-b Polya-Gamma sampler and CRT counts against
the JAX package on the CPU.

- ``_tail_sums`` elementwise against JAX (rtol 1e-5);
- at K != 4 series terms: ``_tail_sums`` against float64 sums (at the
  accuracy of the JAX package's own K = 4 sums) and against JAX's where
  the two use the same formula; the plain sampler against JAX's
  ``pg_gamma_series(..., K=K)`` (KS) and pg_mean (|z| < 6); K = 4 by
  default, bit for bit; K threaded through the mesh path; a K that is no
  whole number >= 1 raises;
- the plain gamma-series sampler (the twin of kernel K4): sample mean and
  variance against pg_mean/pg_var (|z| < 6, the z of the variance from the
  sample's own fourth moment), two-sample KS against JAX's
  ``pg_gamma_series`` and against the exact native oracle (p > 1e-3);
- ``polya_gamma``'s dispatch by regime;
- ``crt_sample`` (the twin of kernel K5) against the exact law and JAX's
  ``crt_sample`` (means within 6 standard errors, variances within 5%).
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from pyglm_tpu.ops import linalg as jl
from pyglm_tpu.ops import polyagamma as jp
from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops import linalg as tl
from pyglm_tpu_torch.ops import polyagamma as tp

torch.set_num_threads(1)
P_MIN = 1e-3
Z_MAX = 6.0
# The kernel's grid: tests/test_pg_pallas.py's plus the NB bench's (4.5, 1).
GRID = [(0.3, 1.0), (1.0, 2.0), (2.5, 0.0), (4.5, 1.0), (13.0, 1.0),
        (40.0, 6.0)]


def _plain(b, c, seed, n, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tp.pg_gamma_series_plain(torch.full((n,), b), torch.full((n,), c),
                                    gen, **kw).numpy().astype(np.float64)


def test_tail_sums_match_jax():
    """rtol 1e-5, except S2 and S3 on 0.5 <= a < 2.1. There the exact
    forms, which take over from the Taylor series at a = 0.5, cancel (S3
    by ~1e4 at a = 0.5), so a one-ulp difference between XLA's and
    PyTorch's float32 atan grows to 1.2e-5 (S2) and 7e-4 (S3) relative;
    that band is held at rtol 2e-5 and 1e-3. Both packages' S3 there are
    ~0.7% from the float64 sum, the midpoint rule's own error."""
    rng = np.random.default_rng(0)
    a = np.concatenate([[0.0, 1e-6, 0.1, 0.49, 0.499, 0.5, 0.51, 1.0, 5.0,
                         50.0, 300.0], rng.uniform(0, 10, 200),
                        np.linspace(0.5, 2.1, 500)])
    a = a.astype(np.float32)
    band = (a >= 0.5) & (a < 2.1)
    got = tp._tail_sums(torch.from_numpy(a), 4)
    ref = jp._tail_sums(jnp.asarray(a), 4)
    for g, r, rtol_band in zip(got, ref, (1e-5, 2e-5, 1e-3)):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g[~band], r[~band], rtol=1e-5, atol=0)
        np.testing.assert_allclose(g[band], r[band], rtol=rtol_band, atol=0)


# Sample points of a: the existing test's, a band over the exact branch's
# start at larger K, and a log grid up to 300.
_A_K = np.concatenate([[0.0, 1e-6, 0.1, 0.49, 0.499, 0.5, 0.51, 1.0, 5.0,
                        50.0, 300.0], np.random.default_rng(0).uniform(
                            0, 10, 200), np.linspace(0.5, 40.0, 300),
                       np.geomspace(1.0, 300.0, 60)]).astype(np.float32)


def _exact_tail_sums(a, K, kmax=20_000):
    """sum_{k>K} d_k^-p, p = 1, 2, 3, in float64: the terms up to kmax,
    then the integral of the rest."""
    a = a.astype(np.float64)
    k = np.arange(K + 1, kmax + 1, dtype=np.float64)
    d = (k - 0.5)[None, :] ** 2 + a[:, None] ** 2
    safe = np.maximum(a, 1e-300)
    r1 = np.where(a > 0, (np.pi / 2 - np.arctan2(kmax, safe)) / safe,
                  1.0 / kmax)
    return ((1 / d).sum(1) + r1, (1 / d ** 2).sum(1) + 1 / (3 * kmax ** 3),
            (1 / d ** 3).sum(1) + 1 / (5 * kmax ** 5))


@pytest.mark.parametrize("K", [1, 2, 4, 8, 64])
def test_tail_sums_at_K_match_float64(K):
    """The sums the tail's moments come from, at K terms, against float64
    sums, within the accuracy the JAX package's own sums have at K = 4
    (1.1e-4, 1.6e-3 and 7.9e-3 at worst on these a): at K = 1 JAX's
    formulas give S3 < 0 for a <= 0.35 (so +inf draws), and above K = 4
    its exact branch cancels for 0.5 <= a << K (at K = 64 S3 is 41x off,
    or <= 0); the port adds the terms K < k <= 4 exactly and starts that
    branch at a = K/8, as kernel K4's run-time body does."""
    got = tp._tail_sums(torch.from_numpy(_A_K), K)
    for g, r, rtol in zip(got, _exact_tail_sums(_A_K, K), (2e-4, 2e-3, 1e-2)):
        g = g.double().numpy()
        assert (g > 0).all()
        np.testing.assert_allclose(g, r, rtol=rtol, atol=0)


@pytest.mark.parametrize("K", [1, 2, 8, 64])
def test_tail_sums_at_K_match_jax_where_the_formulas_agree(K):
    """Against JAX's _tail_sums at K where both packages run the same
    formula (K >= 4, a < 0.5 or a >= K/8): rtol 1e-5, and 2e-5 / 1e-3 for
    S2 / S3 where the exact branch cancels (its first fifth, as at K = 4
    on 0.5 <= a < 2.1). At K = 1 and 2 the formulas differ everywhere: JAX's
    S3 goes negative at K = 1 (asserted) and is 11% off at K = 2."""
    a = _A_K
    got = [g.numpy() for g in tp._tail_sums(torch.from_numpy(a), K)]
    ref = [np.asarray(r) for r in jp._tail_sums(jnp.asarray(a), K)]
    if K < 4:
        exact = _exact_tail_sums(a, K)
        assert np.abs(ref[2] / exact[2] - 1).max() > 0.1
        assert (ref[2] < 0).any() == (K == 1)
        return
    same = (a < 0.5) | (a >= K / 8)
    band = (a >= K / 8) & (a < 4.2 * K / 8)
    assert same.sum() > 100 and band.sum() > 10
    for g, r, rtol_band in zip(got, ref, (1e-5, 2e-5, 1e-3)):
        np.testing.assert_allclose(g[same & ~band], r[same & ~band],
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(g[band], r[band], rtol=rtol_band, atol=0)


# Three points of GRID for the draws at K != 4. At K = 1 the JAX package's
# draws are +inf at the first two (its S3 < 0 for a <= 0.35; asserted), so
# there the port is held against JAX's K = 4 draws, the law both
# approximate.
K_GRID = [(1.0, 2.0), (4.5, 1.0), (40.0, 6.0)]


@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("b,c", K_GRID)
def test_plain_series_at_K_vs_jax(K, b, c):
    n = 50_000
    ours = _plain(b, c, seed=int(b * 100 + c) + 17 * K, n=n, K=K)
    args = (jax.random.key(int(b * 100 + c) + K),
            jnp.full((n,), b, jnp.float32), jnp.full((n,), c, jnp.float32))
    ref = np.asarray(jp.pg_gamma_series(*args, K=K))
    if K == 1 and c < 3.0:
        assert np.isposinf(ref).all()
        ref = np.asarray(jp.pg_gamma_series(*args, K=4))
    assert np.isfinite(ours).all() and (ours > 0).all()
    assert scipy.stats.ks_2samp(ours, ref).pvalue > P_MIN
    m, v = float(tp.pg_mean(b, c)), float(tp.pg_var(b, c))
    assert abs(ours.mean() - m) < Z_MAX * math.sqrt(v / n)


def test_default_K_is_four_bit_for_bit():
    b = torch.tensor([0.3, 1.0, 2.5, 4.5, 13.0, 200.0] * 500)
    c = torch.linspace(-5.0, 5.0, b.numel())
    for fn, kw in ((tp.polya_gamma, {}), (tp.polya_gamma, {"method": "real"}),
                   (tp.pg_gamma_series, {})):
        assert torch.equal(fn(b, c, _gen(3), **kw),
                           fn(b, c, _gen(3), K=4, **kw))
    assert torch.equal(tp.pg_gamma_series_plain(b, c, _gen(4), 170.0),
                       tp.pg_gamma_series_plain(b, c, _gen(4), 170.0, 4))
    # Another K is another draw.
    assert not torch.equal(tp.pg_gamma_series(b, c, _gen(3)),
                           tp.pg_gamma_series(b, c, _gen(3), K=2))


def test_K_reaches_the_mesh_draw(monkeypatch):
    """polya_gamma(mesh=) hands K to the tile's draw: with the mesh's
    tiling replaced by the whole array, it is the unsharded draw at K."""
    monkeypatch.setattr(tp, "_mesh_draw",
                        lambda draw, g, mesh, *arrays: draw(*arrays, g))
    b, c = torch.full((64, 6), 3.5), torch.linspace(-2.0, 2.0, 384)
    for K in (1, 4, 7):
        got = tp.polya_gamma(b, c.reshape(64, 6), _gen(8), method="gamma",
                             K=K, mesh=object())
        assert torch.equal(got, tp.pg_gamma_series(b, c.reshape(64, 6),
                                                   _gen(8), K=K))


@pytest.mark.parametrize("K", [0, -1, 2.5, 4.0, True, "4"])
def test_K_must_be_a_whole_number_of_terms(K):
    b, c = torch.ones(3), torch.zeros(3)
    for call in (lambda: tp.polya_gamma(b, c, _gen(0), K=K),
                 lambda: tp.pg_gamma_series(b, c, _gen(0), K=K),
                 lambda: tp.pg_gamma_series_plain(b, c, _gen(0), K=K)):
        with pytest.raises(ValueError, match="K must be"):
            call()


@pytest.mark.parametrize("b,c", GRID + [(1e-3, 1.0), (0.05, 1.0)])
def test_plain_series_moments(b, c):
    x = _plain(b, c, seed=int(b * 1000 + c), n=100_000)
    assert np.isfinite(x).all() and (x > 0).all()
    m, v = float(tp.pg_mean(b, c)), float(tp.pg_var(b, c))
    z = (x.mean() - m) / math.sqrt(v / x.size)
    assert abs(z) < Z_MAX, (x.mean(), m, z)
    d = x - x.mean()
    s2 = float(np.mean(d * d))
    se = math.sqrt(max(float(np.mean(d ** 4)) - s2 * s2, 0.0) / x.size)
    assert abs(s2 - v) < Z_MAX * se, (s2, v, se)


@pytest.mark.parametrize("b,c", GRID)
def test_plain_series_vs_jax_ks(b, c):
    n = 50_000
    ours = _plain(b, c, seed=int(b * 100 + c) + 7, n=n)
    ref = np.asarray(jp.pg_gamma_series(jax.random.key(int(b * 100 + c)),
                                        jnp.full((n,), b, jnp.float32),
                                        jnp.full((n,), c, jnp.float32)))
    assert scipy.stats.ks_2samp(ours, ref).pvalue > P_MIN


@pytest.mark.parametrize("b,c", [(1, 1.0), (3, 2.0), (13, 0.5)])
def test_plain_series_vs_native_oracle_ks(b, c):
    from pyglm_tpu_torch.native import native_available, pg_int_b_native
    if not native_available():
        pytest.skip("native PG oracle unavailable (no C++ toolchain)")
    n = 50_000
    ours = _plain(b, c, seed=b + 11, n=n)
    ref = pg_int_b_native(np.full(n, float(b)), c, seed=b + 12, n_threads=1)
    assert scipy.stats.ks_2samp(ours, ref).pvalue > P_MIN


def test_small_b_draws_stay_positive():
    """At b << 1 most Gamma terms underflow to 0 in float32, in JAX too;
    the tail shift keeps every draw > 0, and JAX's minimum is the same
    shift."""
    n = 50_000
    for b in (1e-3, 0.05, 0.3):
        x = _plain(b, 1.0, seed=3, n=n)
        ref = np.asarray(jp.pg_gamma_series(
            jax.random.key(3), jnp.full((n,), b, jnp.float32),
            jnp.full((n,), 1.0, jnp.float32)))
        assert (x > 0).all() and (ref > 0).all()
        np.testing.assert_allclose(x.min(), ref.min(), rtol=0.05)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_polya_gamma_regimes():
    c = torch.linspace(-4.0, 4.0, 40_000)
    for method in ("auto", "real", "gamma"):
        assert torch.equal(tp.polya_gamma(0.0, c, _gen(0), method=method),
                           torch.zeros_like(c))
    # "normal" draws every element, as JAX does (b = 0 gives the 1e-30
    # floor).
    x = tp.polya_gamma(0.0, c[:10], _gen(0), method="normal")
    assert torch.all(x == 1e-30)
    # b >= 170: the normal approximation's moments.
    b, cc = 200.0, 1.5
    x = tp.polya_gamma(b, torch.full((40_000,), cc), _gen(1)).double()
    m, v = float(tp.pg_mean(b, cc)), float(tp.pg_var(b, cc))
    assert abs(float(x.mean()) - m) < Z_MAX * math.sqrt(v / x.numel())
    assert abs(float(x.var()) / v - 1.0) < 0.05
    ref = tp.pg_normal_approx(torch.full((40_000,), b),
                              torch.full((40_000,), cc), _gen(1))
    assert torch.equal(x.float(), ref)


def test_polya_gamma_auto_takes_devroye_at_b_one():
    c = torch.linspace(-6.0, 6.0, 999)
    got = tp.polya_gamma(torch.ones(999), c, _gen(5))
    assert torch.equal(got, tp.pg_devroye_plain(c, _gen(5)))
    real = tp.polya_gamma(torch.ones(999), c, _gen(5), method="real")
    assert torch.equal(real, tp.pg_gamma_series_plain(1.0, c, _gen(5),
                                                      normal_cutoff=170.0))


def test_polya_gamma_mixed_b_keeps_shape():
    rng = np.random.default_rng(0)
    b = rng.choice([0.0, 1.0, 0.4, 2.5, 30.0, 250.0], size=(37, 23))
    c = rng.normal(0, 3, size=(37, 23))
    bt = torch.tensor(b, dtype=torch.float32)
    ct = torch.tensor(c, dtype=torch.float32)
    before = dict(_build.LAUNCHES)
    x = tp.polya_gamma(bt, ct, _gen(2))
    assert _build.LAUNCHES == before
    assert x.shape == (37, 23) and x.dtype == torch.float32
    assert torch.all(x[bt == 0] == 0)
    assert torch.isfinite(x).all() and torch.all(x[bt > 0] > 0)
    # The b == 1 elements are drawn first, by Devroye.
    unit = bt == 1.0
    assert torch.equal(x[unit], tp.pg_devroye_plain(ct[unit], _gen(2)))
    # Broadcasting: a (37, 1) b against (37, 23) c.
    assert tp.polya_gamma(bt[:, :1], ct, _gen(3)).shape == (37, 23)


def test_polya_gamma_rejects_bad_method_and_device():
    with pytest.raises(ValueError):
        tp.polya_gamma(1.0, torch.zeros(3), _gen(0), method="saddle")
    with pytest.raises(ValueError):
        tp.polya_gamma(2.0, torch.zeros(3, device="meta"), _gen(0),
                       method="real")
    with pytest.raises(ValueError):
        tl.crt_sample(torch.zeros(3, device="meta"), 1.0, 4, _gen(0))


def test_cuda_wrappers_refuse_cpu_tensors():
    from pyglm_tpu_torch.ops.crt_cuda import crt_sample_cuda
    from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
    with pytest.raises(ValueError):
        pg_gamma_series_cuda(torch.ones(4), torch.zeros(4), 0, 0)
    with pytest.raises(ValueError):
        crt_sample_cuda(torch.ones(4), torch.ones(4), 4, 0, 0)


def test_crt_edge_cases():
    y = torch.tensor([[0, 1, 0], [1, 0, 20]], dtype=torch.int32)
    r = torch.tensor([0.5, 3.0, 1e-3])
    for seed in range(5):
        l = tl.crt_sample(y, r, 16, _gen(seed))
        assert l.dtype == torch.int32 and l.shape == y.shape
        # y = 0 seats no table, y = 1 exactly one (p = r/r = 1).
        assert torch.equal(l[y <= 1], y[y <= 1])
        assert 1 <= int(l[1, 2]) <= 16          # tables only for i < max_y
    # float counts give the same law as int counts.
    lf = tl.crt_sample(y.float(), r, 16, _gen(0))
    assert torch.equal(lf, tl.crt_sample(y, r, 16, _gen(0)))


@pytest.mark.parametrize("y_val,r_val", [(1, 0.5), (4, 2.0), (12, 5.0),
                                         (15, 0.7)])
def test_crt_law_and_jax(y_val, r_val):
    n = 200_000
    ps = np.array([r_val / (r_val + i) for i in range(y_val)])
    m, v = ps.sum(), (ps * (1 - ps)).sum()
    ours = tl.crt_sample(torch.full((n, 1), y_val, dtype=torch.int32),
                         torch.tensor([r_val]), 16, _gen(y_val))
    ours = ours.numpy().astype(np.float64)
    ref = np.asarray(jl.crt_sample(jax.random.key(y_val),
                                   jnp.full((n, 1), y_val, jnp.int32),
                                   jnp.full((1,), r_val), 16), np.float64)
    se = math.sqrt(v / n) + 1e-6
    for x in (ours, ref):
        assert abs(x.mean() - m) < Z_MAX * se, (x.mean(), m)
        if v > 1e-6:
            assert abs(x.var() / v - 1.0) < 0.05, (x.var(), v)
    assert abs(ours.mean() - ref.mean()) < Z_MAX * math.sqrt(2.0) * se


def test_crt_reads_r_by_column():
    n = 100_000
    r = torch.tensor([0.2, 1.0, 8.0])
    l = tl.crt_sample(torch.full((n, 3), 6.0), r, 16, _gen(9)).double()
    for j, rj in enumerate(r.tolist()):
        ps = np.array([rj / (rj + i) for i in range(6)])
        se = math.sqrt((ps * (1 - ps)).sum() / n)
        assert abs(float(l[:, j].mean()) - ps.sum()) < Z_MAX * se
