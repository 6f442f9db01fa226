"""Kernel K5's draws (``csrc/crt.cu``) through its numpy twin, and the CRT
sums form that the NB r updates call, on the CPU.

- ``crt_cuda.crt_sample_twin`` (which repeats K5's Philox draws and its
  division-free test) against a scalar loop over the same Philox words, and
  its counts against the exact law (a sum of independent Bernoulli(r / (r +
  k))): means within 6 standard errors, variances within 5%, a chi-square
  test against the exact pmf (p > 1e-3), and JAX's ``crt_sample`` (means);
- counts past ``max_y`` seat tables only below it; float and int y agree;
- ``crt_sample_sums`` on the CPU equals ``crt_sample_plain`` summed, from
  the same generator state, bit for bit;
- the NB r update and ``NegativeBinomialRegression``'s resample, which call
  the sums form, equal the same update computed from ``crt_sample``'s
  per-element counts summed over time, bit for bit.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from pyglm_tpu.ops import linalg as jl
from pyglm_tpu_torch.models import observations as O
from pyglm_tpu_torch.models import regressions as R
from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops import linalg as tl
from pyglm_tpu_torch.ops.crt_cuda import crt_sample_twin
from pyglm_tpu_torch.ops.ss_cuda import philox4x32
from pyglm_tpu_torch.utils.utils import softplus

torch.set_num_threads(1)
P_MIN = 1e-3
Z_MAX = 6.0
# chip_smoke.py's CRT_GRID (max_y 16) and two high counts (max_y 256).
LAW_CASES = [(1, 0.5, 16), (4, 2.0, 16), (12, 5.0, 16), (15, 0.7, 16),
             (40, 3.0, 256), (200, 10.0, 256)]


def _exact_pmf(y, r):
    """pmf of sum_{k < y} Bern(r / (r + k)), by convolution."""
    pmf = np.array([1.0])
    for k in range(y):
        p = r / (r + k)
        pmf = np.convolve(pmf, [1.0 - p, p])
    return pmf


def _loop_twin(y, r, max_y, seed, offset):
    """K5's draws one trial at a time: element e, trial k >= 1 reads word
    (k - 1) % 4 of Philox((k - 1) // 4, e, offset lo, offset hi; seed)."""
    y, r = np.asarray(y), np.asarray(r, np.float32)
    out = np.zeros(y.size, np.int32)
    M32 = 0xFFFFFFFF
    for e, yv in enumerate(y.reshape(-1)):
        m = int(min(max(yv, 0), max_y)) if yv >= 1 else 0
        rr = r[e % y.shape[-1]]
        out[e] = int(m > 0 and rr > 0)
        for k in range(1, m):
            w = philox4x32(((k - 1) // 4, e, offset & M32, offset >> 32),
                           (seed & M32, seed >> 32))[(k - 1) % 4]
            u = np.float32(int(w) >> 8) * np.float32(2.0 ** -24)
            out[e] += bool(u * (rr + np.float32(k)) < rr)
    return out.reshape(y.shape)


def test_twin_equals_scalar_loop():
    rng = np.random.default_rng(3)
    y = rng.poisson(2.5, (7, 5)).astype(np.int32)
    y[0, 0], y[1, 2], y[3, 4] = 13, 40, 9
    r = np.array([0.4, 1.0, 3.0, 0.0, 7.5], np.float32)
    for seed, offset in ((0, 0), (12345, 2 ** 40 + 7), (2 ** 62 + 3, 99)):
        got = crt_sample_twin(y, r, 16, seed, offset)
        assert got.dtype == np.int32 and got.shape == y.shape
        np.testing.assert_array_equal(got, _loop_twin(y, r, 16, seed,
                                                      offset))
    assert not crt_sample_twin(y, r, 16, 1, 0)[:, 3].any()     # r = 0


def test_twin_chunks_equal_one_pass():
    """The twin's chunks (each on a thread, elements counted from the
    chunk's start) give the draws of one pass, N dividing no chunk."""
    rng = np.random.default_rng(8)
    y = rng.poisson(4.0, (61, 13)).astype(np.int32)
    y[::3, ::5] += 30
    r = rng.uniform(0.2, 6.0, 13).astype(np.float32)
    one = crt_sample_twin(y, r, 16, 2 ** 40 + 1, 5, chunk=y.size)
    for chunk in (1, 7, 128, 500):
        np.testing.assert_array_equal(
            crt_sample_twin(y, r, 16, 2 ** 40 + 1, 5, chunk=chunk), one)
    np.testing.assert_array_equal(one[:2], _loop_twin(y[:2], r, 16,
                                                      2 ** 40 + 1, 5))


@pytest.mark.parametrize("y_val,r_val,max_y", LAW_CASES)
def test_twin_law(y_val, r_val, max_y):
    n = 40_000 if y_val <= 40 else 10_000
    l = crt_sample_twin(np.full((n, 1), y_val, np.int32),
                        np.array([r_val]), max_y, 7 + y_val, 3)[:, 0]
    pmf = _exact_pmf(min(y_val, max_y), r_val)
    ks = np.arange(pmf.size)
    m, v = float((ks * pmf).sum()), float((ks ** 2 * pmf).sum()) - float(
        (ks * pmf).sum()) ** 2
    se = math.sqrt(v / n) + 1e-6
    assert abs(l.mean() - m) < Z_MAX * se, (l.mean(), m)
    if v > 1e-6:
        assert abs(l.var() / v - 1.0) < 0.05, (l.var(), v)
    # chi-square against the pmf, the tails pooled into the end bins
    cdf = np.cumsum(pmf)
    lo = int(np.argmax(n * cdf >= 5))
    hi = int(pmf.size - 1 - np.argmax(n * np.cumsum(pmf[::-1]) >= 5))
    if hi > lo:
        exp = n * np.concatenate([[cdf[lo]], pmf[lo + 1:hi],
                                  [1.0 - cdf[hi - 1]]])
        obs = np.bincount(np.clip(l, lo, hi) - lo, minlength=hi - lo + 1)
        assert scipy.stats.chisquare(obs, exp * n / exp.sum()).pvalue > P_MIN
    if max_y == 16:
        ref = np.asarray(jl.crt_sample(jax.random.key(y_val),
                                       jnp.full((n, 1), y_val, jnp.int32),
                                       jnp.full((1,), r_val), 16), np.float64)
        assert abs(l.mean() - ref.mean()) < Z_MAX * math.sqrt(2.0) * se


def test_twin_counts_past_max_y_and_float_y():
    rng = np.random.default_rng(5)
    y = rng.poisson(6.0, (300, 27)).astype(np.int32)
    y[::7, ::3] += 50                        # past max_y = 16
    r = rng.uniform(0.3, 6.0, 27).astype(np.float32)
    got = crt_sample_twin(y, r, 16, 11, 4)
    np.testing.assert_array_equal(got, crt_sample_twin(np.minimum(y, 16), r,
                                                       16, 11, 4))
    assert got.max() <= 16
    np.testing.assert_array_equal(got, crt_sample_twin(
        y.astype(np.float32), r, 16, 11, 4))
    yf = np.array([[0.0, 1.0, 40.0, np.nan, 0.5, np.inf]], np.float32)
    lf = crt_sample_twin(yf, np.ones(6, np.float32), 16, 0, 0)
    assert lf[0, 0] == 0 and lf[0, 1] == 1 and 1 <= lf[0, 2] <= 16
    assert lf[0, 3] == 0 and lf[0, 4] == 0 and 1 <= lf[0, 5] <= 16


def test_plain_counts_past_max_y_and_float_y():
    y = torch.full((2000, 3), 40, dtype=torch.int32)
    r = torch.tensor([0.5, 2.0, 9.0])
    g = torch.Generator().manual_seed(1)
    l = tl.crt_sample(y, r, 16, g)
    g.manual_seed(1)
    assert torch.equal(l, tl.crt_sample(torch.full_like(y, 16), r, 16, g))
    g.manual_seed(1)
    assert torch.equal(l, tl.crt_sample(y.float(), r, 16, g))


@pytest.mark.parametrize("shape", [(500, 27), (40, 3, 50), (1, 200)])
def test_plain_sums_equal_counts_summed(shape):
    rng = np.random.default_rng(len(shape))
    y = torch.from_numpy(rng.poisson(3.0, shape).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.2, 5.0, shape[-1]).astype(np.float32))
    g = torch.Generator().manual_seed(9)
    s = tl.crt_sample_sums(y, r, 16, g)
    after = g.get_state()
    g.manual_seed(9)
    l = tl.crt_sample_plain(y, r, 16, g)
    assert s.dtype == torch.int64 and s.shape == (shape[-1],)
    assert torch.equal(s, l.reshape(-1, shape[-1]).sum(0))
    assert torch.equal(after, g.get_state())
    with pytest.raises(ValueError):
        tl.crt_sample_sums(torch.zeros(3, device="meta"), 1.0, 4, g)


def test_k5_launches_split_rows_past_32_bit_indices(monkeypatch):
    """K5 indexes a launch's elements in 32 bits: a larger y goes in slabs
    of whole rows, each with its own Philox key; below the limit one
    launch takes the one key the generator gave before."""
    y = torch.arange(301 * 27, dtype=torch.float64).reshape(7, 43, 27)
    g = torch.Generator().manual_seed(5)
    (ys, r, seed, off), = tl._crt_cuda_launches(y, 2.0, g)
    ref = torch.Generator().manual_seed(5)
    assert (seed, off) == _build.philox_seed(ref)
    assert torch.equal(g.get_state(), ref.get_state())
    assert ys.dtype == torch.float32 and ys.shape == (301, 27)
    assert torch.equal(r, torch.full((27,), 2.0))
    monkeypatch.setattr(tl, "_K5_MAX_NUMEL", 100)
    parts = tl._crt_cuda_launches(y.to(torch.int32), 2.0, g)
    assert len(parts) == 101 and all(p[0].numel() <= 100 for p in parts)
    assert torch.equal(torch.cat([p[0] for p in parts]),
                       y.to(torch.int32).reshape(301, 27))
    assert len({p[2:] for p in parts}) == 101


def _parent_r_update(nb, generator, r, Y, psi):
    """The NB r update without its count table, as its per-element form
    computed it: l = crt_sample(...), summed over time."""
    rate = torch.sum(softplus(psi), dim=0)
    l = tl.crt_sample(Y, r, nb.max_y, generator)
    lsum, rate = torch.stack([torch.sum(l, dim=0).to(torch.float32), rate])
    return torch.clamp(tl.sample_gamma(nb.a_r + lsum, generator)
                       / (nb.b_r + rate), min=1e-3)


def test_nb_r_update_bit_identical_to_per_element_sums():
    rng = np.random.default_rng(2)
    Y = torch.from_numpy(rng.poisson(2.0, (400, 9)).astype(np.float32))
    psi = torch.from_numpy(rng.normal(0.0, 1.0, (400, 9)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.5, 4.0, 9).astype(np.float32))
    nb = O.NegativeBinomial(max_y=16)
    for seed in range(3):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        got = nb.resample_aux(g1, {"r": r}, Y, psi)["r"]
        assert torch.equal(got, _parent_r_update(nb, g2, r, Y, psi))
        assert torch.equal(g1.get_state(), g2.get_state())


def test_nb_regression_resample_bit_identical_to_per_element_sums(
        monkeypatch):
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.normal(0, 0.3, (300, 5)).astype(np.float32))
    y = torch.from_numpy(rng.poisson(2.0, (300, 3)).astype(np.float32))
    fits = []
    for parent in (False, True):
        if parent:
            monkeypatch.setattr(
                R, "crt_sample_sums",
                lambda y_, r_, m_, g_: torch.sum(tl.crt_sample(y_, r_, m_,
                                                               g_), dim=0))
        reg = R.NegativeBinomialRegression(3, 5, max_y=16, seed=3,
                                           device="cpu")
        for _ in range(3):
            reg.resample((X, y))
        fits.append((reg.A.copy(), reg.b.copy(), reg.r.copy()))
    for a, b in zip(*fits):
        np.testing.assert_array_equal(a, b)


def test_crt_z_reads_the_law():
    """diagnostics/timing.py::crt_z (the card's law check of both K5
    forms) is near 0 for the plain sampler's sums and far off for sums
    5% too high."""
    from pyglm_tpu_torch.diagnostics.timing import crt_z
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.poisson(4.0, (3000, 20)).astype(np.int32))
    r = torch.from_numpy(rng.uniform(0.5, 5.0, 20).astype(np.float32))
    s = tl.crt_sample_sums(y, r, 64, torch.Generator().manual_seed(2))
    assert abs(crt_z(s, y, r, 64)) < Z_MAX
    assert crt_z(s * 1.05, y, r, 64) > 4 * Z_MAX
