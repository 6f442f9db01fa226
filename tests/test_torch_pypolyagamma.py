"""The pypolyagamma API surface of pyglm_tpu_torch (compat/pypolyagamma.py)
on the CPU, against the JAX package's compat module.

- pgdraw / pgdrawv / module-level pgdrawv / pgdrawvpar: shapes, `out`
  filled in place, positive draws;
- the law: all-ones draws and mixed-b draws, each sample mean within Z_MAX
  standard errors of pg_mean (the standard error from pg_var), and a
  two-sample KS test against the JAX package's pgdrawv (p > P_MIN);
- pgdrawvpar's chunks reproduce each generator's own pgdrawv bit for bit
  (the reference's per-thread static schedule), and one seed reproduces
  itself.
"""
import numpy as np
import pytest
import scipy.stats
import torch

from pyglm_tpu.compat import pypolyagamma as jpp
from pyglm_tpu_torch.compat import PyPolyaGamma, pgdrawv, pgdrawvpar
from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var

torch.set_num_threads(1)
Z_MAX, P_MIN = 6.0, 1e-3


def _z(x, b, c):
    m = pg_mean(torch.as_tensor(b), torch.as_tensor(c)).double()
    v = pg_var(torch.as_tensor(b), torch.as_tensor(c)).double()
    return float((x.sum() - m.sum()) / v.sum().sqrt())


def test_surface():
    ppg = PyPolyaGamma(seed=42, device="cpu")
    assert ppg.pgdraw(1.0, 0.5) > 0
    out = np.zeros(1000)
    ret = ppg.pgdrawv(np.ones(1000), np.full(1000, 1.0), out)
    assert ret is out and np.all(out > 0)
    res = pgdrawv(np.asarray([1.0, 3.5, 100.0, 250.0]), np.ones(4), seed=3,
                  device="cpu")
    assert res.shape == (4,) and res.dtype == np.float32 and np.all(res > 0)
    np.testing.assert_array_equal(
        res, pgdrawv(np.asarray([1.0, 3.5, 100.0, 250.0]), np.ones(4),
                     seed=3, device="cpu"))


@pytest.mark.parametrize("mixed", [False, True])
def test_law_matches_jax(mixed):
    n = 20_000
    rng = np.random.default_rng(0)
    ns = (rng.choice([1.0, 2.5, 7.0], n) if mixed else np.ones(n))
    zs = rng.uniform(-3.0, 3.0, n)
    got = PyPolyaGamma(5, device="cpu").pgdrawv(ns, zs).astype(np.float64)
    ref = np.asarray(jpp.PyPolyaGamma(6).pgdrawv(ns, zs), np.float64)
    assert np.all(got > 0)
    z = _z(torch.from_numpy(got), ns, zs)
    assert abs(z) < Z_MAX, z
    # The same mixture of laws in both: compare the draws scaled by their
    # means (a KS test of the pooled sample).
    m = pg_mean(torch.as_tensor(ns), torch.as_tensor(zs)).double().numpy()
    ks = scipy.stats.ks_2samp(got / m, ref / m)
    assert ks.pvalue > P_MIN, ks


def test_pgdrawvpar_chunks_follow_their_generators():
    ns, zs = np.ones(1001), np.full(1001, 1.0)
    out = np.zeros(1001)
    pgdrawvpar([PyPolyaGamma(1, device="cpu"), PyPolyaGamma(2, device="cpu"),
                PyPolyaGamma(3, device="cpu")], ns, zs, out)
    bounds = np.linspace(0, 1001, 4).astype(int)
    for sd, lo, hi in zip((1, 2, 3), bounds[:-1], bounds[1:]):
        np.testing.assert_array_equal(
            out[lo:hi], PyPolyaGamma(sd, device="cpu").pgdrawv(ns[lo:hi],
                                                               zs[lo:hi]))
    single = np.zeros(1001)
    pgdrawvpar([PyPolyaGamma(1, device="cpu")], ns, zs, single)
    assert not np.array_equal(out, single)
