"""The Gaussian family of pyglm_tpu_torch (models/observations.py) against
the JAX package on the CPU, and its cached-Gram sweeps.

- omega_kappa and log_likelihood against JAX's: rtol 1e-6.
- The eta update's law: 4000 draws (one per neuron, one shared
  conditional) against scipy's invgamma by a KS test, p > 1e-3.
- A sweep on the cached Grams (GLMData.Gfull / XtY dense, the packed group
  Gram Gg0 sparse, both divided by eta) against the same sweep forming
  X' Omega X from the same state and generators: A identical, w within
  1e-4 max|w| sparse; the cached sparse sweep runs the staged loop. The
  dense draw factors the whole (P, P) precision, whose collinear basis
  columns amplify float32 rounding: there J and h agree within 1e-5 of
  their largest entries and w within 5e-4 max|w| (1.0e-4 at this test's
  seed; the assertion message reports it). The same two draws in float64
  agree within 1e-10 max|w| (1.3e-13 at this seed): the float32 gap is
  rounding, not the cache.
- The Gaussian classes construct, add_data, fit and fit_ensemble.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import pyglm_tpu_torch
from pyglm_tpu.models.observations import Gaussian as JaxGaussian
from pyglm_tpu_torch.models import weights
from pyglm_tpu_torch.models.ensemble import chain_generators
from pyglm_tpu_torch.models.observations import Gaussian

torch.set_num_threads(1)


def test_omega_kappa_and_log_likelihood_match_jax():
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((300, 7)).astype(np.float32)
    psi = (0.5 * rng.standard_normal((300, 7))).astype(np.float32)
    eta = (0.2 + rng.random(7)).astype(np.float32)
    jo, to = JaxGaussian(), Gaussian()
    om_j, ka_j = jo.omega_kappa(None, jnp.asarray(Y), jnp.asarray(psi),
                                {"eta": jnp.asarray(eta)})
    om_t, ka_t = to.omega_kappa(None, torch.tensor(Y), torch.tensor(psi),
                                {"eta": torch.tensor(eta)})
    assert om_t.shape == (300, 7) and om_t.is_contiguous()
    np.testing.assert_allclose(om_t.numpy(), np.asarray(om_j), rtol=1e-6)
    np.testing.assert_allclose(ka_t.numpy(), np.asarray(ka_j), rtol=1e-6)
    ll_j = jo.log_likelihood(jnp.asarray(Y), jnp.asarray(psi),
                             {"eta": jnp.asarray(eta)})
    ll_t = to.log_likelihood(torch.tensor(Y), torch.tensor(psi),
                             {"eta": torch.tensor(eta)})
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-6)
    np.testing.assert_allclose(to.mean(torch.tensor(psi), None).numpy(), psi)


def test_eta_update_law():
    n, T = 4000, 50
    rng = np.random.default_rng(1)
    y = rng.standard_normal(T).astype(np.float32)
    Y = torch.tensor(np.repeat(y[:, None], n, axis=1))
    psi = torch.zeros_like(Y)
    fam = Gaussian(a_eta=3.0, b_eta=2.0)
    g = torch.Generator().manual_seed(2)
    eta = fam.resample_aux(g, fam.init_aux(n), Y, psi)["eta"].numpy()
    alpha, beta = 3.0 + 0.5 * T, 2.0 + 0.5 * float((y ** 2).sum())
    p = stats.kstest(eta, stats.invgamma(alpha, scale=beta).cdf).pvalue
    assert p > 1e-3, p
    assert Gaussian(resample_eta=False).resample_aux(
        g, {"eta": torch.ones(3)}, Y[:, :3], psi[:, :3])["eta"].eq(1).all()


def _data(n, t=1500):
    """Stable linear-Gaussian data: small weights, unit noise."""
    return pyglm_tpu_torch.SparseGaussianGLM(
        n, B=2, L=4, seed=3, device="cpu", obs_kwargs=dict(eta_init=0.5),
        net_kwargs=dict(rho_init=0.4, learn_rho=False, sigma_w=0.01,
                        learn_weight_prior=False)).generate(t, keep=False)


@pytest.mark.parametrize("cls", ["GaussianGLM", "SparseGaussianGLM"])
def test_cached_sweep_matches_uncached(cls):
    n = 8
    Y = _data(n)
    m = getattr(pyglm_tpu_torch, cls)(n, B=2, L=4, seed=4, group=4,
                                      device="cpu")
    m.add_data(Y)
    m.fit(n_samples=2)
    d = m.datas[0]
    if m.spike_and_slab:
        assert d.Gg0.shape == (n // 4, 8 * 9 // 2, 1) and d.Gfull is None
        bare = d._replace(Gg0=None)
    else:
        assert d.Gfull.shape == (m.P, m.P) and d.XtY.shape == (m.P, n)
        bare = d._replace(Gfull=None, XtY=None)
    outs = []
    for datas in ((d,), (bare,)):
        outs.append(m._sweep(chain_generators(9, "cpu"), m.state, datas)[0])
        if datas[0] is d and m.spike_and_slab:
            assert weights.LAST_SS_PATH == "staged"
    (c, u) = outs
    if not m.spike_and_slab:
        omega = 1.0 / m.state.aux["eta"].expand(d.Y.shape).contiguous()
        J, h = weights.sufficient_stats(d.Xf, omega, d.Y * omega)
        Jc = d.Gfull * omega[0][:, None, None]
        assert float((Jc - J).abs().max()) <= 1e-5 * float(J.abs().max())
        hc = d.XtY * omega[0]
        assert float((hc - h).abs().max()) <= 1e-5 * float(h.abs().max())
    assert torch.equal(c.A, u.A)
    if m.spike_and_slab:
        assert 0 < int(c.A.sum()) < n * n
    w_c = torch.cat([(c.A[..., None] * c.W).reshape(-1), c.b])
    w_u = torch.cat([(u.A[..., None] * u.W).reshape(-1), u.b])
    tol = 1e-4 if m.spike_and_slab else 5e-4
    err = float((w_c - w_u).abs().max()) / float(w_u.abs().max())
    assert err <= tol, f"max|diff w| / max|w| = {err:.2e}"
    assert torch.allclose(c.aux["eta"], u.aux["eta"], rtol=1e-4)


def test_dense_cached_gap_is_float32_rounding():
    """The dense draw from the cached Gram (Gfull / eta, XtY / eta) and from
    J, h formed from omega = 1/eta, on the same normals, in float32 and in
    float64 (every input cast, Gfull and XtY re-formed in that dtype):
    the float32 gap is within the sweep test's 5e-4 max|w|, the float64
    one at rounding level, 1e-10 max|w|."""
    n = 8
    m = pyglm_tpu_torch.GaussianGLM(n, B=2, L=4, seed=4, device="cpu")
    m.add_data(_data(n))
    m.fit(n_samples=2)
    d = m.datas[0]
    hyp = m.network.edge_hypers(m.state.net, "cpu")
    eps = torch.randn((n, m.P), generator=torch.Generator().manual_seed(9),
                      dtype=torch.float64)
    gaps = {}
    for dt in (torch.float32, torch.float64):
        X, Y = d.Xf.to(dt), d.Y.to(dt)
        inv_eta = 1.0 / m.state.aux["eta"].to(dt)
        G, XtY = weights.sufficient_stats(X, torch.ones_like(Y[:, :1]), Y)
        if dt == torch.float32:
            assert torch.equal(G[0], d.Gfull) and torch.equal(XtY, d.XtY)
        omega = inv_eta.expand(Y.shape).contiguous()
        h = weights.EdgeHypers(*(x.to(dt) for x in hyp))
        w_c = weights.resample_dense(
            None, G[0][None] * inv_eta[:, None, None], XtY * inv_eta, h, 2,
            eps=eps.to(dt))
        w_u = weights.resample_dense(
            None, *weights.sufficient_stats(X, omega, Y * omega), h, 2,
            eps=eps.to(dt))
        gaps[dt] = float((w_c - w_u).abs().max() / w_u.abs().max())
    assert gaps[torch.float32] <= 5e-4, gaps
    assert gaps[torch.float64] <= 1e-10, gaps


def test_sparse_cache_takes_the_modes_gram():
    """Gg0 is the group Gram of one lane of ones at the model's precision
    (bf16-rounded at "default", as its K6 body)."""
    Y = _data(8, 600)
    grams = {}
    for prec in ("high", "default"):
        m = pyglm_tpu_torch.SparseGaussianGLM(8, B=2, L=4, group=4,
                                              precision=prec, device="cpu")
        m.add_data(Y)
        d = m.datas[0]
        want = weights.group_gram_blocks(
            d.Xt, torch.ones((600, 1)), 2, 4, precision=prec)
        assert torch.equal(d.Gg0, want)
        grams[prec] = d.Gg0
    assert not torch.equal(grams["high"], grams["default"])


@pytest.mark.parametrize("cls", ["GaussianGLM", "SparseGaussianGLM"])
def test_gaussian_classes_fit_and_fit_ensemble(cls):
    m = getattr(pyglm_tpu_torch, cls)(6, B=2, L=4, seed=5, device="cpu")
    assert m.observation.name == "gaussian"
    m.add_data(_data(6, 800))
    out = m.fit(n_samples=3)
    assert np.isfinite(out["W"]).all() and np.isfinite(out["lls"]).all()
    assert (m.state.aux["eta"] > 0).all()
    ens = m.fit_ensemble(n_chains=2, n_samples=4)
    assert np.isfinite(ens["lls"]).all() and ens["bias"].shape == (2, 4, 6)
