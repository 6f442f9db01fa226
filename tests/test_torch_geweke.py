"""Geweke joint-distribution tests of the port's Gibbs sweep on the CPU
(pyglm_tpu_torch/diagnostics/geweke.py): the stationary marginals of the
successive-conditional simulator must match the prior. The configs, gates
and chain lengths of the JAX package's tests/test_geweke_smoke.py (the quick
lane: N=3, B=1, T=50, 600 iterations, z < 6) and of the tests/test_geweke.py
cases whose families and priors the port has (3000 iterations, thinned by
10, z < 5; marked slow as there): Erdos-Renyi with a fixed prior, a learned
rho, a learned NIW weight prior, B=2 cross terms, negative binomial with
the count table (on the subcritical prior of tests/test_geweke_tpu.py; see
that test), Binomial, the latent-distance prior, the dense Gaussian, the
SBM and the sparse Gaussian. The last three also have a smoke case in the
quick lane (600 iterations, z < 6).
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.diagnostics.geweke import (
    geweke_chain, ks_two_sample, prior_gates, tau_int,
)
from pyglm_tpu_torch.models.networks import (
    DenseNetworkConfig, ErdosRenyiConfig, LatentDistanceConfig, SBMConfig,
)
from pyglm_tpu_torch.models.observations import (
    Bernoulli, Binomial, Gaussian, NegativeBinomial,
)
from pyglm_tpu_torch.ops.basis import cosine_basis

torch.set_num_threads(1)
N, B, L, T = 3, 1, 3, 50
N_ITERS = 3000
THIN = 10


def _z(mean_emp, mean_true, var_true, n_eff):
    """z-score of an empirical mean against its sampling distribution."""
    return abs(mean_emp - mean_true) / np.sqrt(var_true / n_eff)


def _chain(seed, obs, net, n_iters=N_ITERS, B_=B, spike_slab=True, **kw):
    return geweke_chain(seed, obs, net, N, B_, cosine_basis(B=B_, L=L), T,
                        spike_slab=spike_slab, n_iters=n_iters, device="cpu",
                        **kw)


def _er(**kw):
    base = dict(N=N, B=B, rho_init=0.4, learn_rho=False,
                learn_weight_prior=False, sigma_w=0.5, mu_bias=-1.0,
                sigma_bias=0.3)
    return ErdosRenyiConfig(**{**base, **kw})


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_tau_int_of_an_ar1_series(phi):
    """tau_int of an AR(1) series is (1 + phi) / (1 - phi) within 10%."""
    rng = np.random.default_rng(0)
    e = rng.standard_normal(100_000)
    x = np.empty_like(e)
    x[0] = e[0]
    for t in range(1, x.size):
        x[t] = phi * x[t - 1] + e[t]
    want = (1 + phi) / (1 - phi)
    assert abs(tau_int(x) / want - 1) < 0.1, (tau_int(x), want)


GATE_NET = dict(rho_init=0.4, sigma_w=0.25, mu_bias=-1.5, sigma_bias=0.3)
GATE_R = (4.0, 2.0)


def _prior_series(n=3500, N_=8, B_=4, shift=None, seed=0):
    """Iid draws from the ER prior, NB's Gamma r prior and a count bound,
    as geweke_chain's series; `shift` moves one marginal off the prior."""
    rng = np.random.default_rng(seed)
    net = GATE_NET
    rho = net["rho_init"] + (0.05 if shift == "adjacency" else 0.0)
    A = rng.random((n, N_, N_)) < rho
    sd = np.sqrt(net["sigma_w"]) * (1.2 if shift == "weights" else 1.0)
    W = rng.standard_normal((n, N_, N_, B_)) * sd * A[..., None]
    b = net["mu_bias"] + net["sigma_bias"] * rng.standard_normal((n, N_))
    r = rng.gamma(GATE_R[0], 1 / GATE_R[1], (n, N_))
    return {"bias": b + (0.05 if shift == "bias" else 0.0),
            "A_density": A.mean((1, 2)), "n_active": A.sum((1, 2)) * 1.0,
            "W_sum": W.sum((1, 2, 3)), "W_sq": (W ** 2).sum((1, 2, 3)),
            "r": r * (1.2 if shift == "r" else 1.0),
            "y_max": np.full(n, 10.0)}


@pytest.mark.parametrize("shift", [None, "bias", "adjacency", "weights",
                                   "r"])
def test_prior_gates(shift):
    """prior_gates passes iid prior draws and fails the marginal that is
    moved off the prior (and only that one)."""
    gates = prior_gates(_prior_series(shift=shift), GATE_NET, 4, 500,
                        weights=True, r_prior=GATE_R, max_y=128)
    assert [g[0] for g in gates] == ["bias", "adjacency", "weights", "r"]
    failed = [g[0] for g in gates if not g[1]]
    assert failed == ([shift] if shift else []), gates


def test_geweke_smoke_bernoulli_er():
    net = _er()
    series = _chain(0, Bernoulli(), net, n_iters=600)
    b = series["bias"][::10]
    z = abs(b.mean() - net.mu_bias) / np.sqrt(net.sigma_bias ** 2 / b.size)
    assert z < 6.0, (b.mean(), z)
    dens = series["A_density"][::10]
    z = abs(dens.mean() - 0.4) / np.sqrt(0.24 / (dens.size * N * N))
    assert z < 6.0, (dens.mean(), z)


def test_series_shapes_and_ks():
    """The collected series and their shapes; ks_two_sample on iid draws
    from one law stays under its threshold."""
    series = _chain(1, NegativeBinomial(max_y=64), _er(sigma_w=0.01,
                                                       mu_bias=-1.5),
                    n_iters=5, with_llc=True)
    shapes = {k: v.shape for k, v in series.items()}
    assert shapes == {"bias": (5, N), "A_density": (5,), "n_active": (5,),
                      "W_sum": (5,), "W_sq": (5,), "y_max": (5,),
                      "rho": (5,), "prior_mu": (5, B),
                      "prior_Sigma": (5, B, B), "r": (5, N)}, shapes
    rng = np.random.default_rng(0)
    ks, thresh = ks_two_sample(rng.normal(size=4000), rng.normal(size=4000))
    assert ks < thresh, (ks, thresh)


@pytest.fixture(scope="module")
def bernoulli_er_chain():
    net = _er()
    return _chain(0, Bernoulli(), net), net


@pytest.mark.slow
def test_geweke_bias_marginal(bernoulli_er_chain):
    series, net = bernoulli_er_chain
    b = series["bias"][::THIN]
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, b.shape[0] * N)
    assert z < 5.0, (b.mean(), z)
    assert abs(b.var() / net.sigma_bias ** 2 - 1) < 0.25, b.var()


@pytest.mark.slow
def test_geweke_adjacency_marginal(bernoulli_er_chain):
    series, net = bernoulli_er_chain
    dens = series["A_density"][::THIN]
    z = _z(dens.mean(), net.rho_init, net.rho_init * (1 - net.rho_init),
           dens.shape[0] * N * N)
    assert z < 5.0, (dens.mean(), z)


@pytest.mark.slow
def test_geweke_weight_marginal(bernoulli_er_chain):
    series, net = bernoulli_er_chain
    wsq = series["W_sq"][::THIN]
    nact = series["n_active"][::THIN]
    ratio = wsq.sum() / (nact.sum() * net.sigma_w)
    assert abs(ratio - 1) < 0.2, ratio
    est_mean = series["W_sum"][::THIN].sum() / nact.sum()
    se = np.sqrt(net.sigma_w / nact.sum())
    assert abs(est_mean) < 6 * se, (est_mean, se)


@pytest.mark.slow
def test_geweke_learned_rho_marginal():
    a_rho, b_rho = 3.0, 5.0
    net = _er(a_rho=a_rho, b_rho=b_rho, learn_rho=True)
    series = _chain(1, Bernoulli(), net)
    rho = series["rho"][::THIN]
    m_true = a_rho / (a_rho + b_rho)
    v_true = a_rho * b_rho / ((a_rho + b_rho) ** 2 * (a_rho + b_rho + 1))
    z = _z(rho.mean(), m_true, v_true, rho.shape[0])
    assert z < 5.0, (rho.mean(), m_true, z)
    assert abs(rho.var() / v_true - 1) < 0.35, (rho.var(), v_true)


@pytest.mark.slow
def test_geweke_learned_weight_prior():
    nu0, psi0, kappa0 = 6.0, 2.0, 2.0
    net = ErdosRenyiConfig(
        N=N, B=B, rho_init=0.4, learn_rho=False, learn_weight_prior=True,
        niw_mu0=0.0, niw_kappa0=kappa0, niw_nu0=nu0, niw_psi0=psi0,
        mu_bias=-1.0, sigma_bias=0.3)
    series = _chain(10, Bernoulli(), net)
    # B=1: Sigma ~ IW_1(nu0, Psi0) = InvGamma(nu0/2, Psi0/2)
    Sig = series["prior_Sigma"][::THIN].reshape(-1)
    m_S = psi0 / (nu0 - 2.0)
    v_S = 2.0 * psi0 ** 2 / ((nu0 - 2.0) ** 2 * (nu0 - 4.0))
    z = _z(Sig.mean(), m_S, v_S, Sig.size)
    assert z < 5.0, (Sig.mean(), m_S, z)
    mu = series["prior_mu"][::THIN].reshape(-1)
    v_mu = m_S / kappa0
    z = _z(mu.mean(), 0.0, v_mu, mu.size)
    assert z < 5.0, (mu.mean(), z)
    assert abs(mu.var() / v_mu - 1) < 0.3, mu.var()
    b = series["bias"][::THIN]
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, b.size)
    assert z < 5.0, (b.mean(), z)


@pytest.mark.slow
def test_geweke_b2_cross_terms():
    """B=2: the posterior precisions are non-diagonal 2x2 blocks, so the
    small-B Cholesky and solves' cross terms in the edge scan run."""
    net = _er(B=2)
    series = _chain(8, Bernoulli(), net, B_=2)
    b = series["bias"][::THIN]
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, b.size)
    assert z < 5.0, (b.mean(), z)
    dens = series["A_density"][::THIN]
    z = _z(dens.mean(), 0.4, 0.24, dens.size * N * N)
    assert z < 5.0, (dens.mean(), z)
    wsq = series["W_sq"][::THIN]
    nact = series["n_active"][::THIN]
    ratio = wsq.sum() / (nact.sum() * 2 * net.sigma_w)
    assert abs(ratio - 1) < 0.2, ratio
    est_mean = series["W_sum"][::THIN].sum() / (nact.sum() * 2)
    se = np.sqrt(net.sigma_w / (nact.sum() * 2))
    assert abs(est_mean) < 6 * se, (est_mean, se)


@pytest.mark.slow
def test_geweke_negative_binomial():
    """The gamma-series PG sampler and, through the count table
    (with_llc=True), the collapsed-CRT r update: r's stationary marginal
    is its Gamma(a_r, b_r) prior.

    The prior is the subcritical one of tests/test_geweke_tpu.py's NB lane
    (rho 0.25, sigma_w 0.004, mu_bias -2, r_init 2), not test_geweke.py's
    (rho 0.4, sigma_w 0.01, mu_bias -1.5, r_init 3): under that one the
    exp-link autoregression can run away, as test_geweke_tpu.py measured
    (~1e-3 an iteration at N=8). Here its chain on seed 5 regenerated a
    dataset with counts at the generator's 1e6 cap at iteration 2169, which
    the port's count table refuses (a ValueError above max_y, where the
    JAX package's traced table drops the counts)."""
    a_r, b_r = 4.0, 2.0
    net = _er(rho_init=0.25, sigma_w=0.004, mu_bias=-2.0, sigma_bias=0.2)
    obs = NegativeBinomial(r_init=2.0, resample_r=True, a_r=a_r, b_r=b_r,
                           max_y=128)
    series = _chain(5, obs, net, with_llc=True)
    assert series["y_max"].max() <= obs.max_y
    b = series["bias"][::THIN]
    z = _z(b.mean(), -2.0, 0.2 ** 2, b.size)
    assert z < 5.0, (b.mean(), z)
    r = series["r"][::THIN]
    m_true, v_true = a_r / b_r, a_r / b_r ** 2
    z = _z(r.mean(), m_true, v_true, r.size)
    assert z < 5.0, (r.mean(), z)
    assert abs(r.var() / v_true - 1) < 0.35, r.var()


@pytest.mark.slow
def test_geweke_binomial():
    """Every auxiliary is PG(5, psi), the constant-integer-b regime."""
    net = _er(sigma_w=0.3)
    series = _chain(9, Binomial(n_trials=5), net)
    b = series["bias"][::THIN]
    z = _z(b.mean(), net.mu_bias, net.sigma_bias ** 2, b.size)
    assert z < 5.0, (b.mean(), z)
    dens = series["A_density"][::THIN]
    z = _z(dens.mean(), 0.4, 0.24, dens.size * N * N)
    assert z < 5.0, (dens.mean(), z)
    wsq = series["W_sq"][::THIN]
    nact = series["n_active"][::THIN]
    ratio = wsq.sum() / (nact.sum() * net.sigma_w)
    assert abs(ratio - 1) < 0.25, ratio


@pytest.mark.slow
def test_geweke_latent_distance():
    """The positions' stationary marginal is their N(0, sigma_l^2) prior
    and gamma's its N(0, sigma_gamma^2): the HMC, swap and relocation
    moves end to end. geweke_chain reports generic scalars, so the
    positions are collected by a chain of the same parts."""
    from pyglm_tpu_torch.models.ensemble import chain_generators
    from pyglm_tpu_torch.models.sweep import (
        GLMData, init_state_from_prior, make_generator, make_gibbs_sweep,
    )
    from pyglm_tpu_torch.ops.basis import design_matrix
    sigma_l = 0.8
    net = LatentDistanceConfig(
        N=N, B=B, dim=2, sigma_l=sigma_l, sigma_gamma=1.0, hmc_eps=0.05,
        hmc_steps=10, hmc_iters=3, swap_moves=4, relocate_moves=4,
        learn_weight_prior=False, sigma_w=0.5, mu_bias=-1.0,
        sigma_bias=0.3)
    obs = Bernoulli()
    basis = cosine_basis(B=B, L=L)
    dev = torch.device("cpu")
    gens = chain_generators(3, dev)
    sweep = make_gibbs_sweep(obs, net, N, B, True)
    gen = make_generator(obs, N, B)
    state = init_state_from_prior(gens, obs, net, N, B, True, dev)
    Ls, gammas = [], []
    for _ in range(2000):
        Y, _ = gen(gens.device, state, basis, T)
        Xf = design_matrix(Y, basis)
        state, _ = sweep(gens, state,
                         (GLMData(Y=Y, Xf=Xf, Xt=Xf.T.contiguous()),))
        Ls.append(state.net.L.clone())
        gammas.append(float(state.net.gamma))
    Ls = torch.stack(Ls).numpy()[::THIN]
    z = _z(Ls.mean(), 0.0, sigma_l ** 2, Ls[..., 0].size)
    assert z < 6.0, (Ls.mean(), z)
    assert abs(Ls.var() / sigma_l ** 2 - 1) < 0.3, Ls.var()
    g = np.asarray(gammas)[::THIN]
    z_g = _z(g.mean(), 0.0, 1.0, g.size)
    assert z_g < 6.0, (g.mean(), z_g)


# The cases of tests/test_geweke.py:89 (dense Gaussian), :239 (SBM) and
# :300 (sparse Gaussian): (chain arguments, [(series, mean, variance of one
# draw, draws per iteration)] of the z gates).
A_ETA, B_ETA = 6.0, 2.0
ETA_M = B_ETA / (A_ETA - 1)
ETA_V = B_ETA ** 2 / ((A_ETA - 1) ** 2 * (A_ETA - 2))
NEW_CASES = {
    "gaussian_dense": (
        dict(seed=2, obs=Gaussian(a_eta=A_ETA, b_eta=B_ETA, eta_init=0.5),
             net=DenseNetworkConfig(N=N, B=B, learn_weight_prior=False,
                                    sigma_w=0.003, mu_bias=0.0,
                                    sigma_bias=0.1),
             spike_slab=False),
        [("bias", 0.0, 0.1 ** 2), ("eta", ETA_M, ETA_V)]),
    "sbm": (
        dict(seed=6, obs=Bernoulli(),
             net=SBMConfig(N=N, B=B, K=2, a_rho=2.0, b_rho=3.0,
                           alpha_pi=1.0, sigma_w=0.5, niw_kappa0=1.0,
                           mu_bias=-1.0, sigma_bias=0.3)),
        [("rho", 0.4, 2.0 * 3.0 / (25.0 * 6.0)), ("bias", -1.0, 0.3 ** 2),
         ("pi", 0.5, 1.0 / 12.0)]),
    "gaussian_sparse": (
        dict(seed=7, obs=Gaussian(a_eta=A_ETA, b_eta=B_ETA, eta_init=0.5),
             net=_er(sigma_w=0.003, mu_bias=0.0, sigma_bias=0.1)),
        [("bias", 0.0, 0.1 ** 2), ("A_density", 0.4, 0.24 / (N * N)),
         ("eta", ETA_M, ETA_V)]),
}


def _new_case(name, n_iters, z_max):
    kw, gates = NEW_CASES[name]
    kw = dict(kw)
    series = _chain(kw.pop("seed"), kw.pop("obs"), kw.pop("net"),
                    n_iters=n_iters, **kw)
    for key, mean, var in gates:
        x = series[key][::THIN]
        if key == "pi":
            x = x[:, 0]
        z = _z(x.mean(), mean, var, x.size)
        assert z < z_max, (key, x.mean(), mean, z)
    return series


@pytest.mark.parametrize("name", list(NEW_CASES))
def test_geweke_smoke_new_cases(name):
    _new_case(name, 600, 6.0)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(NEW_CASES))
def test_geweke_new_cases(name):
    series = _new_case(name, N_ITERS, 5.0)
    if name == "sbm":
        # pi_0 ~ Beta(1, 1) stationary; the block-0 label fraction averages
        # 1/2 by symmetry (sensitive to the self-edge term of the labels).
        pi0 = series["pi"][::THIN][:, 0]
        assert abs(pi0.var() / (1.0 / 12.0) - 1) < 0.35, pi0.var()
        cf0 = series["c_frac"][::THIN][:, 0]
        z = _z(cf0.mean(), 0.5, cf0.var() + 1e-12, cf0.size)
        assert z < 5.0, (cf0.mean(), z)


@pytest.mark.slow
def test_sbm_labels_mix_alike_at_the_card_shape():
    """At the card's Geweke shape (N=8, B=4, T=384) the SBM's labels mix
    too slowly for test_geweke_sbm's gates, in the JAX package as in the
    port: the same chain (1500 iterations, the test's prior) has a
    block-0 label fraction with an autocorrelation time over 100 in both,
    the port's within 2x of JAX's, and pi_0's variance ratio (1 under its
    prior) within 0.25 of JAX's. So the card lane runs at the test's own
    shape (chip_smoke.py::GW_LANES)."""
    import jax
    from pyglm_tpu.diagnostics.geweke import geweke_chain as jax_chain
    from pyglm_tpu.models.networks import SBMConfig as JaxSBM
    from pyglm_tpu.models.observations import Bernoulli as JaxBernoulli
    n, b, t, iters = 8, 4, 384, 1500
    kw = dict(K=2, a_rho=2.0, b_rho=3.0, alpha_pi=1.0, sigma_w=0.5,
              niw_kappa0=1.0, mu_bias=-1.0, sigma_bias=0.3)
    basis = cosine_basis(B=b, L=10)
    sj = jax_chain(jax.random.key(14), JaxBernoulli(), JaxSBM(N=n, B=b, **kw),
                   n, b, basis, t, spike_slab=True, n_iters=iters,
                   seg_iters=250)
    sp = geweke_chain(14, Bernoulli(), SBMConfig(N=n, B=b, **kw), n, b,
                      basis, t, spike_slab=True, n_iters=iters,
                      device="cpu")
    tau = [tau_int(s["c_frac"][:, 0]) for s in (sj, sp)]
    var = [12.0 * s["pi"][:, 0].var() for s in (sj, sp)]
    print(f"block-0 fraction tau (JAX, port) {tau}; pi_0 variance ratio "
          f"{var}")
    assert min(tau) > 100 and tau[1] < 2 * tau[0], tau
    assert abs(var[1] - var[0]) < 0.25, var
