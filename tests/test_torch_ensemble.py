"""The lane-stacked ensemble of pyglm_tpu_torch (models/ensemble.py,
NonlinearAutoregressiveModel.fit_ensemble) and its convergence metrics
against the JAX package on the CPU.

- _to_lanes/_from_lanes: exact.
- A C = 3 stacked spike-and-slab update equals three per-chain updates on
  the sliced lanes of the same noise (A identical, w atol 1e-4): the lane
  independence the ensemble rests on, for both loops.
- collect="mean" equals the mean of collect="samples" from the same seeds.
- split_rhat and ess_per_chain: 1e-10, including the inf case.
- A small latent-distance ensemble (N=20, T=3000, C=4, 10 + 15 sweeps):
  its pooled link AUC is within AUC_MARGIN of the JAX ensemble's on the
  same data.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu.models import ensemble as je
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu.utils import metrics as jm_metrics
from pyglm_tpu_torch.models import ensemble as te
from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.utils import metrics as tm
from pyglm_tpu_torch.utils.metrics import link_auc

torch.set_num_threads(1)

# Pooled-AUC margin of the LD ensemble. Calibrated over seeds 0-4 at this
# size (10 + 15 sweeps): port minus JAX was +0.024, +0.010, -0.004, -0.016,
# -0.016 (JAX 0.77-0.91, the port 0.80-0.91); twice the worst gap is the
# margin. The test runs seed 2 (JAX 0.911, port 0.907).
AUC_MARGIN = 0.05


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def test_lanes_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    for shape in [(3, 5, 4), (2, 6, 3, 4), (4, 2, 5, 3, 3)]:
        x = rng.standard_normal(shape).astype(np.float32)
        ref = np.asarray(je._to_lanes(jnp.asarray(x)))
        got = te._to_lanes(_t(x))
        np.testing.assert_array_equal(got.numpy(), ref)
        back = te._from_lanes(got, shape[0])
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(je._from_lanes(jnp.asarray(ref),
                                                    shape[0])))
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_stacked_update_equals_per_chain_updates(path):
    C, N, B, G, T = 3, 8, 4, 2, 1200
    rng = np.random.default_rng(1)
    Y = (rng.random((T, N)) < 0.15).astype(np.float32)
    Xt = _t(np.asarray(design_matrix(jnp.asarray(Y),
                                     cosine_basis(B, 10))).T)
    P, lanes = N * B + 1, C * N
    w = _t(rng.standard_normal((P, lanes)) * (rng.random((P, lanes)) < 0.3))
    omega = _t(0.05 + 0.2 * rng.random((T, lanes)))
    kappa = _t(np.tile(Y, (1, C)) - 0.5)
    psi = Xt.T @ w
    M = rng.standard_normal((N, lanes, B, B))
    hyp = tw.EdgeHypers(
        _t(0.1 * rng.standard_normal((N, lanes, B))),
        _t(M @ np.swapaxes(M, -1, -2) / B + np.eye(B)),
        _t(rng.normal(-1.0, 0.5, (N, lanes))), _t(np.full(lanes, -2.0)),
        _t(np.ones(lanes)))
    gen = torch.Generator().manual_seed(2)
    noise = tw.SpikeSlabNoise(torch.rand((N // G, G, lanes), generator=gen),
                              torch.randn((N // G, G, lanes, B),
                                          generator=gen),
                              torch.randn((lanes,), generator=gen))
    A_all, w_all, u_all, _ = tw.resample_spike_slab_tspace(
        None, Xt, omega, kappa, psi, w, hyp, B, group=G, noise=noise,
        path=path, precision="high")
    for c in range(C):
        sl = slice(c * N, (c + 1) * N)
        A_c, w_c, u_c, _ = tw.resample_spike_slab_tspace(
            None, Xt, omega[:, sl].contiguous(), kappa[:, sl].contiguous(),
            psi[:, sl].contiguous(), w[:, sl].contiguous(),
            tw.EdgeHypers(*(x[..., sl] if x.ndim == 1 else x[:, sl]
                            for x in hyp)), B, group=G,
            noise=tw.SpikeSlabNoise(noise.u_a[..., sl], noise.eps[:, :, sl],
                                    noise.bias[sl]), path=path,
            precision="high")
        np.testing.assert_array_equal(A_all[:, sl].numpy(), A_c.numpy())
        np.testing.assert_allclose(w_all[:, sl].numpy(), w_c.numpy(),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(u_all[:, sl].numpy(), u_c.numpy(),
                                   rtol=0, atol=1e-3)


def _small_model(network="erdos_renyi", seed=0):
    truth = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        6, observation="bernoulli", network=network, spike_and_slab=True,
        seed=50 + seed, device="cpu",
        net_kwargs=dict(mu_bias=-1.5) | (dict(rho_init=0.3, learn_rho=False)
                                         if network == "erdos_renyi" else {}))
    m = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        6, observation="bernoulli", network=network, spike_and_slab=True,
        seed=seed, device="cpu")
    m.add_data(truth.generate(800, keep=False))
    return m


@pytest.mark.parametrize("network", ["erdos_renyi", "latent_distance"])
def test_collect_mean_equals_mean_of_samples(network):
    m = _small_model(network)
    state0 = m.state
    kw = dict(n_chains=3, n_samples=5, n_burnin=2, seeds=[4, 7, 9])
    mean = m.fit_ensemble(collect="mean", **kw)
    samp = m.fit_ensemble(collect="samples", **kw)
    assert m.state is state0
    np.testing.assert_allclose(mean["A_mean"], samp["A"].mean(1), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(mean["Weff_mean"], samp["W"].sum(-1).mean(1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mean["lls"], samp["lls"])
    np.testing.assert_allclose(mean["A_mean_pooled"],
                               samp["A"].mean((0, 1)), atol=1e-6)
    assert mean["lls"].shape == (3, 5) and np.isfinite(mean["lls"]).all()
    assert np.isfinite(mean["rhat_ll"]) and np.isfinite(samp["rhat_ll"])
    assert samp["rhat_edge"].shape == (6, 6)
    assert samp["rhat_bias"].shape == (6,)
    assert len(mean["final_states"]) == 3
    assert not np.array_equal(samp["A"][0], samp["A"][1])
    if network == "latent_distance":
        net = mean["final_states"][1].net
        assert net.L.shape == (6, 2) and 0 <= float(net.hmc_accept) <= 1


def test_sequential_ensemble_restores_the_model():
    m = _small_model(seed=1)
    state0, gens0 = m.state, m.generators
    g_state = gens0.device.get_state().clone()
    out = m.fit_ensemble(n_chains=2, n_samples=4, stacked=False)
    assert out["A"].shape == (2, 4, 6, 6) and out["lls"].shape == (2, 4)
    assert m.state is state0 and m.generators is gens0
    assert torch.equal(gens0.device.get_state(), g_state)
    with pytest.raises(ValueError):
        m.fit_ensemble(n_chains=2, n_samples=4, stacked=False,
                       collect="mean")
    with pytest.raises(ValueError, match="Mesh"):
        m.fit_ensemble(n_chains=2, n_samples=4, mesh=object())
    with pytest.raises(ValueError):
        m.fit_ensemble(n_chains=1, n_samples=4)


def test_split_rhat_and_ess_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 50, 3, 2))
    x[1] += 0.5                                 # a chain apart
    x[:, :, 0, 0] = 1.0                         # constant and agreeing: 1
    x[:, :, 0, 1] = 0.0
    x[2, :, 0, 1] = 1.0                         # constant, disagreeing: inf
    got, ref = tm.split_rhat(x), np.asarray(jm_metrics.split_rhat(x))
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert got[0, 0] == 1.0 and np.isinf(got[0, 1])
    assert np.all(got[1:] > 1.0)
    ar = np.zeros(400)
    for t in range(1, 400):
        ar[t] = 0.8 * ar[t - 1] + rng.standard_normal()
    for trace in (ar, rng.standard_normal(400), np.ones(10)):
        assert tm.ess_per_chain(trace) == pytest.approx(
            jm_metrics.ess_per_chain(trace), rel=1e-10)
    with pytest.raises(ValueError):
        tm.split_rhat(x[:1])


def test_latent_distance_ensemble_auc_matches_jax():
    seed, N, T, C = 2, 20, 3000, 4
    kw = dict(B=4, L=10, observation="bernoulli", network="latent_distance",
              spike_and_slab=True)
    truth = pyglm_tpu.NonlinearAutoregressiveModel(
        N, seed=100 + seed, net_kwargs=dict(dim=2, mu_bias=-1.5), **kw)
    Y = truth.generate(T, keep=False)
    A_true = np.asarray(truth.state.A)
    fit = dict(n_chains=C, n_samples=15, n_burnin=10, collect="mean")
    jm = pyglm_tpu.NonlinearAutoregressiveModel(
        N, seed=seed, net_kwargs=dict(dim=2), **kw)
    jm.add_data(Y)
    rj = jm.fit_ensemble(**fit)
    pm = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        N, seed=seed, net_kwargs=dict(dim=2), device="cpu", **kw)
    pm.add_data(Y)
    rp = pm.fit_ensemble(**fit)
    auc_j = link_auc(rj["A_mean_pooled"], A_true)
    auc_p = link_auc(rp["A_mean_pooled"], A_true)
    assert auc_p >= auc_j - AUC_MARGIN, (auc_p, auc_j)
    assert auc_p > 0.75
    assert rp["lls"].shape == (C, 15) and np.isfinite(rp["lls"]).all()
    assert np.isfinite(rp["rhat_ll"])


def test_convert_latent_distance_and_stacked_states():
    """A JAX latent-distance state and a stacked (C-leading) JAX ensemble
    state carry over to the port and back unchanged."""
    from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
    states = [pyglm_tpu.NonlinearAutoregressiveModel(
        5, network="latent_distance", spike_and_slab=True, seed=sd).state
        for sd in (3, 4)]
    stacked = je.stack_states(states)
    for st in (states[0], stacked):
        parts = [np.asarray(x) for x in (st.A, st.W, st.b)]
        net = tuple(np.asarray(x) for x in st.net)
        pm = state_from_numpy(*parts, net, device="cpu",
                              network="latent_distance")
        assert type(pm.net).__name__ == "LatentDistanceState"
        back = state_to_numpy(pm)
        for got, ref in zip((back["A"], back["W"], back["b"]), parts):
            np.testing.assert_array_equal(got, ref)
        for got, ref in zip(back["net"], net):
            np.testing.assert_array_equal(got, ref)
    chains = te.unstack_states(pm, 2)            # pm: the stacked state
    assert chains[1].net.L.shape == (5, 2)
    np.testing.assert_array_equal(chains[1].A.numpy(),
                                  np.asarray(states[1].A))
