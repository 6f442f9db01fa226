"""Parallel tempering in pyglm_tpu_torch (models/tempering.py,
NonlinearAutoregressiveModel.fit_tempered, the families'
tempered_omega_kappa) against the JAX package on the CPU.

- swap_permutation: given JAX's parity bit and uniforms (drawn from its
  key), the port's perm and accepts equal JAX's exactly, for random lls
  and ladders; the perm is a pairwise involution; equal betas always swap.
- suggest_ladder: equal to JAX's to 1e-12, its clamp warning included.
- tempered_omega_kappa: kappa equal to JAX's exactly for every family,
  the Gaussian omega too; the Bernoulli, Binomial and NB omega at beta in
  {0.05, 0.3, 1} agree in law: the sample mean within Z_MAX standard errors
  of pg_mean(beta b, psi), and a two-sample KS test against JAX's
  polya_gamma(method="real") draws (p > P_MIN). Every draw is > 0.
- The tempered pass's wiring, exactly: a Gaussian rung at beta with
  resample_eta=False is the untempered Gaussian at eta / beta, so the
  tempered pass over C rungs and the untempered stacked sweep with
  eta_c = eta / beta_c give identical A, W and b from the same generators
  (betas powers of two, so eta / beta and beta / eta round exactly).
- fit_tempered's contract, validation, NARROW warning, blocker and other
  families (JAX tests/test_tempering.py:67-173); the cold rung against the
  untempered ensemble is slow, as in the JAX package.
"""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

import pyglm_tpu_torch as pt
from pyglm_tpu.models import observations as jo
from pyglm_tpu.models import tempering as jt
from pyglm_tpu_torch.models import observations as to
from pyglm_tpu_torch.models import tempering as tt
from pyglm_tpu_torch.models.ensemble import (
    chain_generators, make_stacked_sweep,
)
from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var

torch.set_num_threads(1)
Z_MAX = 6.0
P_MIN = 1e-3
NET = dict(rho_init=0.3, learn_rho=False, mu_bias=-1.5, sigma_bias=0.3,
           sigma_w=0.8, learn_weight_prior=False)
NB_NET = dict(rho_init=0.2, learn_rho=False, mu_bias=-2.5, sigma_bias=0.1,
              sigma_w=0.05, learn_weight_prior=False)


def _model(seed=0, **kw):
    return pt.SparseBernoulliGLM(6, B=2, L=5, seed=seed, net_kwargs=NET,
                                 device="cpu", **kw)


def _fitted(T=600):
    Y = _model(seed=42).generate(T, keep=False)
    m = _model(seed=0)
    m.add_data(Y)
    return m


# --- swap_permutation -------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_swap_permutation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    C = 3 + seed
    betas = np.sort(rng.uniform(0.6, 1.0, C)).astype(np.float32)
    betas[-1] = 1.0
    lls = (rng.standard_normal(C) * 3.0 - 100.0).astype(np.float32)
    key = jax.random.key(seed)
    perm_j, acc_j, par_j = jt.swap_permutation(key, jnp.asarray(lls),
                                               jnp.asarray(betas))
    # JAX's own draws: the parity bit and one uniform per rung.
    kp, ka = jax.random.split(key)
    parity = int(jax.random.bernoulli(kp, 0.5))
    us = np.array(jax.random.uniform(ka, (C,)))
    perm, acc, par = tt.swap_permutation(None, lls, betas, parity=parity,
                                         uniforms=us)
    assert par == int(par_j)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))


def test_swap_permutation_is_pairwise():
    """An involution of adjacent pairs: applied twice it is the identity,
    every move is to a neighbour, and exactly the accepted rungs move."""
    betas = np.linspace(0.9, 1.0, 6)
    gen = torch.Generator().manual_seed(0)
    for s in range(20):
        lls = np.random.default_rng(100 + s).standard_normal(6) * 50.0
        perm, acc, _ = tt.swap_permutation(gen, lls, betas)
        p = perm.numpy()
        assert np.array_equal(p[p], np.arange(6))
        assert np.max(np.abs(p - np.arange(6))) <= 1
        assert np.array_equal(acc.numpy() > 0, p != np.arange(6))


def test_swap_always_accepts_at_equal_beta():
    """log alpha = 0 at equal betas: every valid pair swaps."""
    lls = np.asarray([-10.0, 40.0, 7.0, -3.0])
    gen = torch.Generator().manual_seed(1)
    for _ in range(10):
        perm, _, parity = tt.swap_permutation(gen, lls, np.ones(4))
        p = perm.numpy()
        valid = np.ones(4, bool)
        if parity == 1:
            valid[0] = valid[-1] = False
        assert np.all((p != np.arange(4)) == valid)


# --- suggest_ladder ---------------------------------------------------------

@pytest.mark.parametrize("sd,C,accept", [(2000.0, 8, 0.3), (57.3, 4, 0.2),
                                         (311.0, 6, 0.5)])
def test_suggest_ladder_matches_jax(sd, C, accept):
    got, span = tt.suggest_ladder(sd, C, accept=accept)
    ref, span_j = jt.suggest_ladder(sd, C, accept=accept)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert abs(span - span_j) < 1e-12
    assert got[-1] == 1.0 and np.all(np.diff(got) > 0)


def test_suggest_ladder_clamps_like_jax():
    with pytest.warns(UserWarning, match="clamping") as rec:
        got, span = tt.suggest_ladder(2.0, 8, accept=0.3)
    with pytest.warns(UserWarning, match="clamping") as rec_j:
        ref, span_j = jt.suggest_ladder(2.0, 8, accept=0.3)
    assert str(rec[0].message) == str(rec_j[0].message)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert abs(span - span_j) < 1e-12
    assert got[0] == pytest.approx(0.05) and np.all(got > 0)


# --- tempered_omega_kappa ---------------------------------------------------

FAMILIES = {
    "bernoulli": (dict(), None),
    "binomial": (dict(n_trials=3), None),
    "negative_binomial": (dict(resample_r=False), "r"),
    "gaussian": (dict(resample_eta=False), "eta"),
}


def _families(name):
    kw, _ = FAMILIES[name]
    return jo.make_observation(name, **kw), to.make_observation(name, **kw)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tempered_kappa_equals_jax(name):
    """kappa (and the Gaussian's omega) exactly, betas random per lane."""
    jfam, tfam = _families(name)
    rng = np.random.default_rng(3)
    T, lanes = 200, 7
    Y = rng.integers(0, 4, (T, lanes)).astype(np.float32)
    if name == "bernoulli":
        Y = np.minimum(Y, 1)
    psi = rng.standard_normal((T, lanes)).astype(np.float32)
    beta = rng.uniform(0.05, 1.0, lanes).astype(np.float32)
    aux_key = FAMILIES[name][1]
    aux = (None if aux_key is None else
           {aux_key: rng.uniform(0.3, 3.0, lanes).astype(np.float32)})
    om_j, ka_j = jfam.tempered_omega_kappa(
        jax.random.key(0), jnp.asarray(Y), jnp.asarray(psi),
        None if aux is None else {k: jnp.asarray(v) for k, v in aux.items()},
        jnp.asarray(beta))
    om_t, ka_t = tfam.tempered_omega_kappa(
        torch.Generator().manual_seed(0), torch.from_numpy(Y),
        torch.from_numpy(psi),
        None if aux is None else {k: torch.from_numpy(v)
                                  for k, v in aux.items()},
        torch.from_numpy(beta))
    np.testing.assert_array_equal(ka_t.numpy(), np.asarray(ka_j))
    if name == "gaussian":
        np.testing.assert_array_equal(om_t.numpy(), np.asarray(om_j))
    else:
        assert bool((om_t > 0).all()) and bool(torch.isfinite(om_t).all())


# (family, y, aux): each draw is PG(beta b(y), psi) with b(y) = 1, n = 3,
# y + r = 3 + 2.
LAW = {"bernoulli": (1.0, None, 1.0), "binomial": (2.0, None, 3.0),
       "negative_binomial": (3.0, {"r": 2.0}, 5.0)}


@pytest.mark.parametrize("beta", [0.05, 0.3, 1.0])
@pytest.mark.parametrize("name", list(LAW))
def test_tempered_omega_law(name, beta):
    jfam, tfam = _families(name)
    y, aux, b = LAW[name]
    n, psi = 20_000, 0.7
    Y = np.full((n, 1), y, np.float32)
    P = np.full((n, 1), psi, np.float32)
    bv = np.asarray([beta], np.float32)
    om = tfam.tempered_omega_kappa(
        torch.Generator().manual_seed(11), torch.from_numpy(Y),
        torch.from_numpy(P),
        None if aux is None else {k: torch.tensor([v])
                                  for k, v in aux.items()},
        torch.from_numpy(bv))[0].numpy().ravel().astype(np.float64)
    om_j = np.asarray(jfam.tempered_omega_kappa(
        jax.random.key(12), jnp.asarray(Y), jnp.asarray(P),
        None if aux is None else {k: jnp.asarray([v])
                                  for k, v in aux.items()},
        jnp.asarray(bv))[0]).ravel().astype(np.float64)
    assert np.all(om > 0) and np.all(np.isfinite(om))
    m = float(pg_mean(beta * b, psi))
    se = float(pg_var(beta * b, psi)) ** 0.5 / n ** 0.5
    z = (om.mean() - m) / se
    assert abs(z) < Z_MAX, (z, om.mean(), m)
    ks = scipy.stats.ks_2samp(om, om_j)
    assert ks.pvalue > P_MIN, ks


# --- the tempered pass's wiring ---------------------------------------------

@pytest.mark.parametrize("spike_slab", [True, False])
def test_gaussian_tempered_pass_is_untempered_at_eta_over_beta(spike_slab):
    betas = np.asarray([0.25, 0.5, 1.0])
    m = pt.NonlinearAutoregressiveModel(
        5, B=2, L=5, observation="gaussian", network="erdos_renyi",
        spike_and_slab=spike_slab, seed=0, device="cpu",
        obs_kwargs=dict(resample_eta=False, eta_init=0.5),
        net_kwargs=NB_NET)
    m.generate(300, keep=True)
    st = tt.init_tempered_states(m, betas)
    beta_c = torch.tensor(betas, dtype=torch.float32)[:, None]
    st_u = st._replace(aux={"eta": st.aux["eta"] / beta_c})
    tpass = tt._make_tempered_pass(m.observation, m.network, 5, 2,
                                   torch.tensor(betas), spike_slab,
                                   group=m.group)
    usweep = make_stacked_sweep(m.observation, m.network, 5, 2, 3,
                                spike_slab, group=m.group)
    g1, g2 = chain_generators(7, "cpu"), chain_generators(7, "cpu")
    datas = tuple(m.datas)
    for _ in range(3):
        st, _ = tpass(g1, st, datas)
        st_u, _ = usweep(g2, st_u, datas)
    for f in ("A", "W", "b"):
        assert torch.equal(getattr(st, f), getattr(st_u, f)), f
    assert float(st.A.sum()) > 0


# --- fit_tempered -----------------------------------------------------------

def test_fit_tempered_contract():
    m = _fitted()
    betas = np.linspace(0.97, 1.0, 4)
    out = m.fit_tempered(n_samples=30, n_burnin=20, betas=betas)
    assert out["A"].shape == (30, 6, 6)
    assert out["W"].shape == (30, 6, 6, 2)
    assert out["bias"].shape == (30, 6)
    assert out["lls"].shape == (30,)
    assert np.isfinite(out["lls"]).all()
    assert np.allclose(out["betas"], betas)
    # Per-attempt rates from the parity bits drawn: true probabilities.
    assert out["swap_rate"].shape == (4,)
    assert np.all(out["swap_rate"] >= 0) and np.all(out["swap_rate"] <= 1)
    assert out["swap_rate"][1:-1].mean() > 0.05, out["swap_rate"]
    assert out["ladder_span"] == pytest.approx(betas[-1] - betas[0])
    assert out["sd_ll"] is None and out["pilot_sweeps"] == 0


def test_fit_tempered_swaps_every_state_field():
    """A swap carries the whole rung state: with equal betas every valid
    pair swaps, and the permuted stacked state is each field's rows in
    the permuted order (here on the latent-distance prior, whose state
    holds device tensors, host tensors and hmc_accept)."""
    m = pt.NonlinearAutoregressiveModel(
        6, B=2, L=5, network="latent_distance", spike_and_slab=True,
        seed=0, device="cpu", net_kwargs=dict(dim=2))
    m.generate(200, keep=True)
    st = tt.init_tempered_states(m, np.ones(4))
    perm = torch.tensor([1, 0, 3, 2])
    out = tt.permute_states(st, perm)
    flat = [(a, b) for a, b in zip(out[:3], st[:3])]
    flat += list(zip(out.net, st.net))
    for new, old in flat:
        assert torch.equal(new, old[perm])
    assert len(out.net) == 5                       # hmc_accept included


def test_fit_tempered_validates_betas():
    m = _fitted(300)
    with pytest.raises(ValueError, match="positive"):
        m.fit_tempered(n_samples=4, betas=np.asarray([-0.1, 0.5, 1.0]))
    with pytest.raises(ValueError, match="ascending"):
        m.fit_tempered(n_samples=4, betas=np.asarray([1.0, 0.5, 0.2]))
    with pytest.raises(ValueError, match="beta=1"):
        m.fit_tempered(n_samples=4, betas=np.asarray([0.5, 0.9]))
    with pytest.raises(ValueError, match="max_sweeps_per_launch"):
        m.fit_tempered(n_samples=4, thin=5, max_sweeps_per_launch=4,
                       betas=np.asarray([0.5, 1.0]))
    with pytest.raises(ValueError, match="Mesh"):
        m.fit_tempered(n_samples=4, betas=np.asarray([0.5, 1.0]),
                       mesh=object())


def test_fit_tempered_warns_on_narrow_auto_ladder():
    """A large sd(ll) makes the pilot's ladder narrow, and the user is
    told; the pilot is stubbed to a config-5-scale fluctuation."""
    m = _fitted(300)
    lls = np.tile(np.asarray([-1000.0, 1000.0]), 20)     # sd(ll) = 1000
    m.fit_compiled = lambda **kw: {"lls": lls}
    with pytest.warns(UserWarning, match="NARROW"):
        out = m.fit_tempered(n_samples=8, n_burnin=4, n_rungs=3,
                             pilot_sweeps=30)
    assert out["sd_ll"] == pytest.approx(1000.0)
    assert out["pilot_sweeps"] == 60
    assert 0 < out["ladder_span"] < 0.01


def test_fit_tempered_pilot_restores_the_model():
    """The pilot is scaffolding: the model's state and generators are as
    before, so its next sweep is the one it would have made."""
    m, ref = _fitted(300), _fitted(300)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = m.fit_tempered(n_samples=3, n_rungs=3, pilot_sweeps=5)
    assert out["pilot_sweeps"] == 10 and out["sd_ll"] > 0
    m.resample_model()
    ref.resample_model()
    for f in ("A", "W", "b"):
        assert torch.equal(getattr(m.state, f), getattr(ref.state, f))


def test_fit_tempered_blocks_resampled_likelihood_aux():
    for obs, flag in (("negative_binomial", "resample_r"),
                      ("gaussian", "resample_eta")):
        m = pt.NonlinearAutoregressiveModel(
            4, B=2, L=5, observation=obs, network="erdos_renyi",
            spike_and_slab=True, seed=0, device="cpu", net_kwargs=NB_NET)
        m.generate(200, keep=True)
        with pytest.raises(ValueError, match=flag):
            m.fit_tempered(n_samples=4, betas=np.asarray([0.99, 1.0]))


@pytest.mark.parametrize("obs,okw", [
    ("negative_binomial", dict(resample_r=False)),
    ("binomial", dict(n_trials=3)),
    ("gaussian", dict(resample_eta=False, eta_init=0.5)),
])
def test_fit_tempered_other_families(obs, okw):
    m = pt.NonlinearAutoregressiveModel(
        5, B=2, L=5, observation=obs, network="erdos_renyi",
        spike_and_slab=True, seed=0, obs_kwargs=okw, net_kwargs=NB_NET,
        device="cpu")
    m.generate(300, keep=True)
    out = m.fit_tempered(n_samples=10, n_burnin=5,
                         betas=np.linspace(0.99, 1.0, 3))
    assert out["A"].shape == (10, 5, 5)
    assert np.isfinite(out["lls"]).all()
    assert np.all(out["swap_rate"] >= 0)
    assert out["swap_rate"].mean() > 0.05, out["swap_rate"]


def test_sharded_tempering_is_not_ported():
    """The mesh tempering sweeps are ported (tests/test_torch_chain_mesh.py,
    test_torch_chain_data_mesh.py); what is not a Mesh raises ValueError,
    as the JAX package's assertions do."""
    m = _model(seed=0)
    for fn in (tt.make_tempered_sweep_sharded, tt.make_tempered_sweep_gspmd):
        with pytest.raises(ValueError, match="Mesh"):
            fn(m.observation, m.network, 4, 2, [0.5, 1.0], None)


@pytest.mark.slow
def test_tempered_cold_chain_matches_untempered():
    """The cold rung's posterior functionals against the untempered
    ensemble's, with the JAX test's tolerances (pilot ladder path)."""
    Y = _model(seed=7).generate(800, keep=False)
    m = _model(seed=0)
    m.add_data(Y)
    plain = m.fit_ensemble(n_chains=4, n_samples=150, n_burnin=60)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tmp = m.fit_tempered(n_samples=600, n_burnin=60, n_rungs=4,
                             pilot_sweeps=100)
    A_p = plain["A"].reshape(-1, 6, 6).mean(0)
    A_t = tmp["A"].mean(0)
    b_p = plain["bias"].reshape(-1, 6).mean(0)
    b_t = tmp["bias"].mean(0)
    assert np.max(np.abs(A_p - A_t)) < 0.22, (A_p, A_t)
    assert abs(A_p.mean() - A_t.mean()) < 0.08
    assert np.max(np.abs(b_p - b_t)) < 0.35, (b_p, b_t)
    ll_p, ll_t = plain["lls"].mean(), tmp["lls"].mean()
    assert abs(ll_p - ll_t) / abs(ll_p) < 0.02
    assert np.all(tmp["swap_rate"] >= 0)
