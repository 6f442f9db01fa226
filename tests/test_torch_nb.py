"""The count families and the NB slice: pyglm_tpu_torch against pyglm_tpu on
the CPU.

(a) NegativeBinomial and Binomial: elementwise log-likelihood and the
    cached total (rtol 1e-5), the count table (equal), kappa (exact), and
    the omega draws' mean (|z| < 6 against sum pg_mean(b, psi), both
    packages);
(b) the NB dispersion update's law in both branches (collapsed CRT over the
    count table, elementwise CRT) against JAX's over many repetitions;
(c) SparseNegativeBinomialGLM at N=5, B=2, L=4, T=1000 (the shapes of
    tests/test_numpy_parity.py's NB config): log-likelihood parity at the
    same state, r included; a state round trip; generation at the same
    state; and both packages fitting the same Y from the same initial state.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu.models import observations as jo
from pyglm_tpu_torch.models import observations as to
from pyglm_tpu_torch.ops.basis import cosine_basis
from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var
from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
Z_MAX = 6.0
N, B, L, T = 5, 2, 4, 1000
TRUTH_NET = dict(rho_init=0.35, learn_rho=False, mu_bias=-1.0,
                 sigma_bias=0.3, learn_weight_prior=False, sigma_w=0.01)
OBS = dict(max_y=64)

# Chain-level gates of test_posterior_agrees_with_jax (100 burn-in + 300
# kept sweeps per package). Calibrated over seeds 0-4, the worst values
# seen were a mean |diff| of the edge marginals of 0.061, of the biases of
# 0.133 and a mean relative gap in r of 0.129; the gates are twice those.
# (b, r) mix slowly along the NB mean ridge r e^b: two JAX chains from the
# same state differ as much (0.049 / 0.162 / 0.223 at seeds 1 and 3).
# The test runs seed 0 (0.041 / 0.067 / 0.060).
MAX_EDGE_DIFF = 0.12
MAX_BIAS_DIFF = 0.27
MAX_R_GAP = 0.26


def _counts_psi(seed, T_, N_, max_y=15):
    rng = np.random.default_rng(seed)
    psi = rng.normal(-1.0, 0.8, (T_, N_)).astype(np.float32)
    Y = np.minimum(rng.negative_binomial(3, 0.6, (T_, N_)),
                   max_y).astype(np.float32)
    return Y, psi


def _families():
    return [(jo.NegativeBinomial(max_y=16), to.NegativeBinomial(max_y=16),
             {"r": np.array([0.3, 1.0, 2.5, 7.0], np.float32)}),
            (jo.Binomial(n_trials=15), to.Binomial(n_trials=15), None)]


def _aux(aux, lib):
    if aux is None:
        return None
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in aux.items()}
    return {k: torch.from_numpy(v) for k, v in aux.items()}


@pytest.mark.parametrize("i", [0, 1], ids=["nb", "binomial"])
def test_family_likelihood_and_cache_match_jax(i):
    jf, tf, aux = _families()[i]
    Y, psi = _counts_psi(i, 3000, 4)
    ja, ta = _aux(aux, "jax"), _aux(aux, "torch")
    Yt, psit = torch.from_numpy(Y), torch.from_numpy(psi)
    ll_j = np.asarray(jf.log_likelihood(jnp.asarray(Y), jnp.asarray(psi), ja))
    ll_t = tf.log_likelihood(Yt, psit, ta).numpy()
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5, atol=1e-5)
    cj, ct = jf.ll_cache(jnp.asarray(Y)), tf.ll_cache(Yt)
    assert set(cj) == set(ct)
    if "counts" in cj:
        np.testing.assert_array_equal(ct["counts"].numpy(),
                                      np.asarray(cj["counts"]))
    else:       # a float32 sum over T*N: equal up to summation order
        np.testing.assert_allclose(float(ct["logC_sum"]),
                                   float(cj["logC_sum"]), rtol=1e-6)
    for cache_j, cache_t in ((cj, ct), (None, None)):
        s_j = float(jf.log_likelihood_sum(jnp.asarray(Y), jnp.asarray(psi),
                                          ja, cache_j))
        s_t = float(tf.log_likelihood_sum(Yt, psit, ta, cache_t))
        np.testing.assert_allclose(s_t, s_j, rtol=1e-5)


@pytest.mark.parametrize("i", [0, 1], ids=["nb", "binomial"])
def test_family_omega_kappa_match_jax(i):
    jf, tf, aux = _families()[i]
    Y, psi = _counts_psi(10 + i, 20_000, 4)
    ja, ta = _aux(aux, "jax"), _aux(aux, "torch")
    om_j, ka_j = jf.omega_kappa(jax.random.key(i), jnp.asarray(Y),
                                jnp.asarray(psi), ja)
    om_t, ka_t = tf.omega_kappa(torch.Generator().manual_seed(i),
                                torch.from_numpy(Y), torch.from_numpy(psi),
                                ta)
    np.testing.assert_array_equal(ka_t.numpy(), np.asarray(ka_j))
    b = (Y + aux["r"][None, :] if aux is not None
         else np.full_like(Y, float(tf.n_trials)))
    m = pg_mean(torch.from_numpy(b), torch.from_numpy(psi)).double().sum()
    sd = pg_var(torch.from_numpy(b), torch.from_numpy(psi)).double().sum()
    sd = math.sqrt(float(sd))
    for om in (om_t.double(), torch.from_numpy(np.asarray(om_j, np.float64))):
        assert torch.isfinite(om).all() and (om > 0).all()
        assert abs(float(om.sum() - m)) < Z_MAX * sd


def test_count_table_matches_jax_bincount():
    Y, _ = _counts_psi(3, 5000, 7, max_y=16)
    Y[0, 0] = 16.0                         # the top row of the table
    got = to.NegativeBinomial(max_y=16).ll_cache(torch.from_numpy(Y))
    ref = jo.NegativeBinomial(max_y=16).ll_cache(jnp.asarray(Y))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(ref["counts"]))
    assert got["counts"].shape == (17, 7)


@pytest.mark.parametrize("cached", [True, False], ids=["crt_table",
                                                        "crt_elementwise"])
def test_r_update_law_matches_jax(cached):
    """r' | Y, psi, r over 2000 repetitions in each package: the per-neuron
    means agree within 6 standard errors of the difference and the
    standard deviations within 10%."""
    reps, T_, N_ = 2000, 300, 4
    Y, psi = _counts_psi(20, T_, N_)
    r = np.array([0.3, 1.0, 2.5, 7.0], np.float32)
    jf, tf = jo.NegativeBinomial(max_y=16), to.NegativeBinomial(max_y=16)
    Yj, psij = jnp.asarray(Y), jnp.asarray(psi)
    cache_j = jf.ll_cache(Yj) if cached else None

    @jax.jit
    def draw_j(keys):
        return jax.vmap(lambda k: jf.resample_aux(
            k, {"r": jnp.asarray(r)}, Yj, psij, cache=cache_j)["r"])(keys)

    rj = np.asarray(draw_j(jax.random.split(jax.random.key(0), reps)),
                    np.float64)
    Yt, psit = torch.from_numpy(Y), torch.from_numpy(psi)
    cache_t = tf.ll_cache(Yt) if cached else None
    gen = torch.Generator().manual_seed(0)
    rt = np.stack([tf.resample_aux(gen, {"r": torch.from_numpy(r)}, Yt,
                                   psit, cache=cache_t)["r"].numpy()
                   for _ in range(reps)]).astype(np.float64)
    se = np.sqrt((rj.var(0) + rt.var(0)) / reps)
    assert np.all(np.abs(rt.mean(0) - rj.mean(0)) < Z_MAX * se)
    np.testing.assert_allclose(rt.std(0), rj.std(0), rtol=0.1)
    assert np.all(rt >= 1e-3)


def test_add_data_rejects_counts_above_max_y():
    m = pyglm_tpu_torch.SparseNegativeBinomialGLM(3, B=B, L=L,
                                                  obs_kwargs=dict(max_y=4))
    Y = np.zeros((50, 3), np.float32)
    Y[7, 1] = 5.0
    with pytest.raises(ValueError, match="max_y"):
        m.add_data(Y)
    with pytest.raises(ValueError, match="max_y"):
        m.observation.ll_cache(torch.from_numpy(Y))
    Y[7, 1] = 4.0
    m.add_data(Y)
    assert m.datas[0].llc["counts"].shape == (5, 3)


def _basis():
    return cosine_basis(B=B, L=L)


def _truth_and_data(seed):
    truth = pyglm_tpu.SparseNegativeBinomialGLM(
        N, basis=_basis(), seed=321 + seed,
        obs_kwargs=dict(r_init=4.0, resample_r=False, **OBS),
        net_kwargs=TRUTH_NET)
    Y = np.minimum(truth.generate(T, keep=False), 63.0)
    return truth, Y


def _jax_model(seed):
    return pyglm_tpu.SparseNegativeBinomialGLM(
        N, basis=_basis(), seed=seed, obs_kwargs=dict(r_init=2.0, **OBS),
        net_kwargs=TRUTH_NET)


def _port_like(jm, seed):
    """A port model on the CPU set to the JAX model's exact state."""
    pm = pyglm_tpu_torch.SparseNegativeBinomialGLM(
        N, basis=_basis(), seed=seed, obs_kwargs=dict(r_init=2.0, **OBS),
        net_kwargs=TRUTH_NET)
    s = jm.state
    pm.state = state_from_numpy(np.asarray(s.A), np.asarray(s.W),
                                np.asarray(s.b),
                                tuple(np.asarray(x) for x in s.net),
                                aux={"r": np.asarray(s.aux["r"])})
    return pm


R_SET = np.array([0.4, 1.3, 2.0, 5.5, 11.0], np.float32)


def _jax_model_with_r(seed):
    """A JAX model whose r is set away from r_init, per neuron."""
    jm = _jax_model(seed)
    jm.state = jm.state._replace(aux={"r": jnp.asarray(R_SET)})
    return jm


def test_log_likelihood_parity_with_r():
    truth, Y = _truth_and_data(0)
    jm = _jax_model_with_r(3)
    jm.add_data(Y)
    pm = _port_like(jm, 3)
    pm.add_data(Y)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-5)
    np.testing.assert_allclose(pm.log_likelihood(Y[:400]),
                               jm.log_likelihood(Y[:400]), rtol=1e-5)
    diag = pm.resample_model()
    np.testing.assert_allclose(diag["log_likelihood"], pm.log_likelihood(),
                               rtol=1e-4)


def test_state_round_trip_with_r():
    jm = _jax_model_with_r(4)
    back = state_to_numpy(_port_like(jm, 4).state)
    np.testing.assert_array_equal(back["aux"]["r"], R_SET)
    np.testing.assert_array_equal(back["W"], np.asarray(jm.state.W))
    np.testing.assert_array_equal(back["b"], np.asarray(jm.state.b))
    m = pyglm_tpu_torch.SparseBernoulliGLM(N, B=B, L=L)
    assert state_to_numpy(m.state)["aux"] is None


def test_generate_matches_jax_in_law():
    """From the same state, the per-neuron mean count of a long generated
    train agrees with JAX's within 6 standard errors (bins treated as
    independent: the weights are small, so the coupling is weak)."""
    truth, _ = _truth_and_data(2)
    Tg = 20_000
    Yj = np.asarray(truth._generate(jax.random.key(5), truth.state,
                                    truth.basis, T=Tg)[0], np.float64)
    pm = _port_like(truth, 5)
    Yp = pm.generate(Tg, keep=False).astype(np.float64)
    assert Yp.shape == (Tg, N) and np.all(Yp == np.round(Yp))
    se = np.sqrt((Yj.var(0) + Yp.var(0)) / Tg)
    assert np.all(np.abs(Yp.mean(0) - Yj.mean(0)) < Z_MAX * se), (
        Yp.mean(0), Yj.mean(0), se)


def _fit_both(seed, n_burn=100, n_keep=300):
    truth, Y = _truth_and_data(seed)
    jm = _jax_model(seed)
    jm.add_data(Y)
    pm = _port_like(jm, seed)
    pm.add_data(Y)
    out = {}
    for name, m in (("jax", jm), ("port", pm)):
        A = np.zeros((N, N))
        b = np.zeros(N)
        r = np.zeros(N)
        for it in range(n_burn + n_keep):
            m.resample_model()
            if it >= n_burn:
                A += np.asarray(m.A)
                b += np.asarray(m.bias)
                r += np.asarray(m.state.aux["r"])
        out[name] = (A / n_keep, b / n_keep, r / n_keep)
    (Aj, bj, rj), (Ap, bp, rp) = out["jax"], out["port"]
    return (float(np.abs(Ap - Aj).mean()), float(np.abs(bp - bj).mean()),
            float(np.mean(np.abs(rp - rj) / rj)))


def test_posterior_agrees_with_jax():
    edge, bias, r_gap = _fit_both(0)
    assert edge <= MAX_EDGE_DIFF, edge
    assert bias <= MAX_BIAS_DIFF, bias
    assert r_gap <= MAX_R_GAP, r_gap


def test_binomial_model_matches_jax_and_runs():
    """A spike-and-slab Binomial GLM (n = 3): log-likelihood parity with
    JAX at the same state (rtol 1e-5), then generation and sweeps."""
    kw = dict(observation="binomial", network="erdos_renyi",
              spike_and_slab=True, obs_kwargs=dict(n_trials=3),
              net_kwargs=TRUTH_NET, basis=_basis())
    jm = pyglm_tpu.NonlinearAutoregressiveModel(N, seed=6, **kw)
    Y = jm.generate(800, keep=False)
    jm.add_data(Y)
    pm = pyglm_tpu_torch.NonlinearAutoregressiveModel(N, seed=6, **kw)
    s = jm.state
    pm.state = state_from_numpy(np.asarray(s.A), np.asarray(s.W),
                                np.asarray(s.b),
                                tuple(np.asarray(x) for x in s.net))
    pm.add_data(Y)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-5)
    Yp = pm.generate(300, keep=False)
    assert Yp.min() >= 0 and Yp.max() <= 3 and np.all(Yp == np.round(Yp))
    lls = pm.fit(n_samples=4)["lls"]
    assert np.isfinite(lls).all()


def test_two_datasets_sum_their_count_tables():
    """Two datasets' count tables add up to the concatenation's; the
    sweep's total (from the summed tables) equals log_likelihood() at the
    new state (rtol 1e-4, float32 sums in another order)."""
    _, Y = _truth_and_data(3)
    jm = _jax_model_with_r(7)
    pm = _port_like(jm, 7)
    pm.add_data(Y[:600])
    pm.add_data(Y[600:])
    whole = pm.observation.ll_cache(torch.from_numpy(Y.astype(np.float32)))
    np.testing.assert_array_equal(
        (pm.datas[0].llc["counts"] + pm.datas[1].llc["counts"]).numpy(),
        whole["counts"].numpy())
    diag = pm.resample_model()
    np.testing.assert_allclose(diag["log_likelihood"], pm.log_likelihood(),
                               rtol=1e-4)
