"""The dense weight update and the full-Gram statistics of pyglm_tpu_torch
(models/weights.py) against the JAX package on the CPU, and the dense
models end to end.

- sufficient_stats and diag_blocks against JAX's: max|diff| / max|J| <= 1e-5
  (float32 sums over T in another order).
- resample_dense with JAX's own normals injected (its per-neuron keys):
  max|diff w| <= 1e-3 max|w| (two Cholesky factorisations of (P, P)
  precisions in float32).
- The full-Gram resample_spike_slab with JAX's uniforms and normals
  injected: A identical, w atol 1e-4; and against the port's residual-space
  update (resample_spike_slab_tspace) on the same noise: A identical.
- The dense draw is the same at every precision mode (the dense path is
  fp32 at every mode).
- The default NonlinearAutoregressiveModel (dense, Bernoulli) and the dense
  convenience classes construct, add_data, fit and fit_ensemble.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyglm_tpu_torch
from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.models.weights import EdgeHypers, SpikeSlabNoise

torch.set_num_threads(1)
T, N, B, G = 1500, 8, 2, 4
P = N * B + 1


def _problem(seed):
    """Design, PG-like omega, kappa, psi, weights and priors as numpy."""
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.2).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 4)))
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (0.5 * rng.standard_normal((N, N, B)) * A[..., None]).astype(
        np.float32)
    b = (-1.5 + 0.2 * rng.standard_normal(N)).astype(np.float32)
    w_full = np.asarray(jw.pack_weights(jnp.asarray(A), jnp.asarray(W),
                                        jnp.asarray(b)))
    omega = (0.05 + 0.2 * rng.random((T, N))).astype(np.float32)
    M = rng.standard_normal((N, N, B, B))
    Lam = (M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(np.float32)
    hyp = dict(mu=(0.1 * rng.standard_normal((N, N, B))).astype(np.float32),
               Lam=Lam,
               logit_rho=rng.normal(-1.0, 0.5, (N, N)).astype(np.float32),
               mu_b=np.full(N, -2.0, np.float32),
               lam_b=np.full(N, 1.0, np.float32))
    return dict(Xf=Xf, w_full=w_full, psi=(Xf @ w_full).astype(np.float32),
                omega=omega, kappa=Y - 0.5, hyp=hyp)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _hyps(p):
    return (jw.EdgeHypers(**{k: jnp.asarray(v) for k, v in p["hyp"].items()}),
            EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()}))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def stats():
    p = _problem(0)
    J, h = jw.sufficient_stats(jnp.asarray(p["Xf"]), jnp.asarray(p["omega"]),
                               jnp.asarray(p["kappa"]))
    Jt, ht = tw.sufficient_stats(_t(p["Xf"]), _t(p["omega"]),
                                 _t(p["kappa"]))
    return p, (np.asarray(J), np.asarray(h)), (Jt, ht)


def test_sufficient_stats_match_jax(stats):
    _, (J, h), (Jt, ht) = stats
    assert Jt.shape == (N, P, P) and ht.shape == (P, N)
    assert _rel(Jt, J) <= 1e-5
    assert _rel(ht, h) <= 1e-5


def test_sufficient_stats_chunk_batches():
    """Batches of 512-step chunks give the sums of one batch (T not a
    multiple of the chunk, several batches)."""
    p = _problem(1)
    X, om, ka = _t(p["Xf"]), _t(p["omega"]), _t(p["kappa"])
    J1, h1 = tw.sufficient_stats(X, om, ka)
    saved = tw._CHUNK_BATCH_BYTES
    try:
        tw._CHUNK_BATCH_BYTES = 4 * N * P * tw.T_CHUNK   # one chunk a batch
        assert len(tw._chunks(T, N * P)) == 3
        J2, h2 = tw.sufficient_stats(X, om, ka)
    finally:
        tw._CHUNK_BATCH_BYTES = saved
    assert _rel(J2, J1) <= 1e-6 and torch.equal(h1, h2)


def test_diag_blocks_match_jax():
    p = _problem(2)
    Jd = jw.diag_blocks(jnp.asarray(p["Xf"]), jnp.asarray(p["omega"]), B)
    Jdt = tw.diag_blocks(_t(p["Xf"]), _t(p["omega"]), B)
    assert Jdt.shape == (N, N, B, B)
    assert _rel(Jdt, Jd) <= 1e-5


def _jax_dense_eps(key, n, P_):
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(k, (P_,), jnp.float32))
                     for k in keys])


def test_resample_dense_matches_jax_on_its_normals(stats):
    p, (J, h), _ = stats
    hj, ht = _hyps(p)
    key = jax.random.key(3)
    w_j = np.asarray(jw.resample_dense(key, jnp.asarray(J), jnp.asarray(h),
                                       hj, B))
    w_t = tw.resample_dense(None, _t(J), _t(h), ht, B,
                            eps=_t(_jax_dense_eps(key, N, P)))
    assert w_t.shape == (P, N)
    assert _rel(w_t, w_j) <= 1e-3


def _jax_ss_noise(key, n_post, n_pre):
    """JAX's resample_spike_slab noise in SpikeSlabNoise's layout."""
    u = np.empty((n_pre, n_post), np.float32)
    eps = np.empty((n_pre, n_post, B), np.float32)
    bias = np.empty(n_post, np.float32)
    for n, kn in enumerate(jax.random.split(key, n_post)):
        ks = jax.random.split(kn, n_pre + 1)
        for j in range(n_pre):
            k1, k2 = jax.random.split(ks[j])
            u[j, n] = jax.random.uniform(k1, ())
            eps[j, n] = jax.random.normal(k2, (B,))
        bias[n] = jax.random.normal(ks[n_pre], ())
    return SpikeSlabNoise(_t(u)[None], _t(eps)[None], _t(bias))


def test_full_gram_spike_slab_matches_jax(stats):
    p, (J, h), _ = stats
    hj, ht = _hyps(p)
    key = jax.random.key(4)
    A_j, w_j = jw.resample_spike_slab(key, jnp.asarray(J), jnp.asarray(h),
                                      jnp.asarray(p["w_full"]), hj, B)
    A_t, w_t = tw.resample_spike_slab(None, _t(J), _t(h), _t(p["w_full"]),
                                      ht, B, noise=_jax_ss_noise(key, N, N))
    assert 0 < int(A_t.sum()) < N * N
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-4)


def test_full_gram_spike_slab_matches_residual_space(stats):
    """The cross-check of the JAX package: the full-Gram update and the
    residual-space one (staged loop, fp32) on the same noise."""
    p, _, (Jt, ht) = stats
    _, hyp = _hyps(p)
    g = torch.Generator().manual_seed(5)
    noise = SpikeSlabNoise(torch.rand((N // G, G, N), generator=g),
                           torch.randn((N // G, G, N, B), generator=g),
                           torch.randn((N,), generator=g))
    A1, w1 = tw.resample_spike_slab(None, Jt, ht, _t(p["w_full"]), hyp, B,
                                    noise=noise)
    A2, w2, _, _ = tw.resample_spike_slab_tspace(
        None, _t(p["Xf"]).T.contiguous(), _t(p["omega"]), _t(p["kappa"]),
        _t(p["psi"]), _t(p["w_full"]), hyp, B, group=G, noise=noise,
        precision="highest")
    assert 0 < int(A1.sum()) < N * N
    assert torch.equal(A1, A2)
    assert _rel(w1, w2) <= 1e-4


def _dense_data(n=6, t=1200):
    return pyglm_tpu_torch.BernoulliGLM(
        n, B=B, L=4, seed=1, device="cpu", net_kwargs=dict(
            sigma_w=0.05, mu_bias=-1.5,
            learn_weight_prior=False)).generate(t, keep=False)


def test_dense_draw_equal_at_every_precision():
    Y = _dense_data()
    states = []
    for prec in ("default", "sr", "high", "highest"):
        m = pyglm_tpu_torch.BernoulliGLM(6, B=B, L=4, seed=2, precision=prec,
                                         device="cpu")
        m.add_data(Y)
        for _ in range(2):
            m.resample_model()
        states.append(m.state)
    for st in states[1:]:
        for k in ("A", "W", "b"):
            assert torch.equal(getattr(st, k), getattr(states[0], k)), k
        assert torch.equal(st.net.Sigma, states[0].net.Sigma)


def test_default_model_runs_a_sweep():
    m = pyglm_tpu_torch.NonlinearAutoregressiveModel(6, B=B, L=4,
                                                     device="cpu")
    assert not m.spike_and_slab and m.network.name == "dense"
    m.add_data(_dense_data())
    d = m.resample_model()
    assert np.isfinite(d["log_likelihood"]) and d["n_edges"] == 36
    assert (m.A == 1).all() and np.isfinite(m.W).all()


@pytest.mark.parametrize("cls,kw", [
    ("BernoulliGLM", {}),
    ("NegativeBinomialGLM", dict(obs_kwargs=dict(max_y=64))),
    ("BinomialGLM", dict(obs_kwargs=dict(n_trials=3))),
])
def test_dense_classes_fit_and_fit_ensemble(cls, kw):
    m = getattr(pyglm_tpu_torch, cls)(5, B=B, L=4, seed=3, device="cpu",
                                      **kw)
    assert not m.spike_and_slab and m.network.name == "dense"
    Y = m.generate(800, keep=False)
    m.add_data(Y)
    out = m.fit(n_samples=3)
    assert out["W"].shape == (3, 5, 5, B) and np.isfinite(out["W"]).all()
    assert (out["A"] == 1).all()
    ens = m.fit_ensemble(n_chains=2, n_samples=4)
    assert ens["W"].shape == (2, 4, 5, 5, B)
    assert np.isfinite(ens["lls"]).all() and (ens["A"] == 1).all()
