"""The model accessors of pyglm_tpu_torch/models/glm.py against the JAX
package's on the CPU: on a JAX state carried in by state_from_numpy,
W_effective, means and log_probability match at rtol 1e-5 (Bernoulli and
negative binomial: the logistic and the exp mean); copy_sample round-trips
through state_from_numpy; forecast has JAX's shape; and the generator
seeded with observed history (ring0) gives JAX's psi at the first bin and,
on JAX's uniforms, JAX's spikes at every bin.
"""
import jax
import numpy as np
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)
N, B, L, T = 6, 2, 4, 300
NET = dict(rho_init=0.4, learn_rho=False, mu_bias=-1.5, sigma_bias=0.3,
           learn_weight_prior=False, sigma_w=0.1)
FAMILIES = {
    "bernoulli": (pyglm_tpu.SparseBernoulliGLM,
                  pyglm_tpu_torch.SparseBernoulliGLM, {}),
    "negative_binomial": (pyglm_tpu.SparseNegativeBinomialGLM,
                          pyglm_tpu_torch.SparseNegativeBinomialGLM,
                          dict(obs_kwargs=dict(r_init=3.0, max_y=64))),
}


def _data(name):
    rng = np.random.default_rng(5)
    if name == "negative_binomial":
        return np.minimum(rng.negative_binomial(2, 0.6, (T, N)),
                          60).astype(np.float32)
    return (rng.random((T, N)) < 0.2).astype(np.float32)


def _pair(name):
    """A JAX model with data and a couple of sweeps behind it, and a port
    model on the CPU set to the same state and data."""
    jcls, pcls, kw = FAMILIES[name]
    Y = _data(name)
    jm = jcls(N, B=B, L=L, seed=3, net_kwargs=NET, **kw)
    jm.add_data(Y)
    jm.resample_model()
    jm.resample_model()
    pm = pcls(N, B=B, L=L, seed=3, net_kwargs=NET, device="cpu", **kw)
    s = jm.state
    aux = (None if s.aux is None
           else {k: np.asarray(v) for k, v in s.aux.items()})
    pm.state = state_from_numpy(np.asarray(s.A), np.asarray(s.W),
                                np.asarray(s.b),
                                tuple(np.asarray(x) for x in s.net),
                                device="cpu", aux=aux, network=pm.network)
    pm.add_data(Y)
    return jm, pm, Y


@pytest.mark.parametrize("name", list(FAMILIES))
def test_accessors_match_jax(name):
    jm, pm, _ = _pair(name)
    assert pm.A.sum() > 0
    np.testing.assert_allclose(pm.W_effective, jm.W_effective, rtol=1e-5,
                               atol=1e-7)
    (mp,), (mj,) = pm.means, jm.means
    assert mp.shape == (T, N)
    np.testing.assert_allclose(mp, np.asarray(mj), rtol=1e-5)
    np.testing.assert_allclose(pm.log_probability(), jm.log_probability(),
                               rtol=1e-5)


@pytest.mark.parametrize("network", ["erdos_renyi", "latent_distance"])
def test_copy_sample_round_trips(network):
    m = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        N, B=B, L=L, observation="negative_binomial", network=network,
        spike_and_slab=True, seed=4, device="cpu",
        obs_kwargs=dict(max_y=64), net_kwargs=dict(sigma_w=0.01))
    m.add_data(_data("negative_binomial"))
    m.resample_model()
    snap = m.copy_sample()
    assert all(isinstance(snap[k], np.ndarray) for k in ("A", "W", "b"))
    back = state_from_numpy(snap["A"], snap["W"], snap["b"], snap["net"],
                            device="cpu", aux=snap["aux"],
                            network=m.network)
    for got, want in zip(back[:3], m.state[:3]):
        assert torch.equal(got, want)
    assert torch.equal(back.aux["r"], m.state.aux["r"])
    for got, want in zip(back.net, m.state.net):
        assert torch.equal(got, want.cpu())
    # The snapshot is a copy: sweeping on leaves it unchanged.
    A0 = snap["A"].copy()
    m.resample_model()
    np.testing.assert_array_equal(snap["A"], A0)


def test_forecast_shape_matches_jax():
    jm, pm, _ = _pair("bernoulli")
    fj = jm.forecast(7, n_samples=3, thin=1)
    fp = pm.forecast(7, n_samples=3, thin=1)
    assert fp.shape == fj.shape == (3, 7, N)
    assert set(np.unique(fp)) <= {0.0, 1.0}
    # Zero thinning: no sweep between futures, the state stays put.
    A0 = pm.A.copy()
    assert pm.forecast(5, n_samples=2, thin=0).shape == (2, 5, N)
    np.testing.assert_array_equal(pm.A, A0)


def test_forecast_pads_short_history():
    pm = pyglm_tpu_torch.SparseBernoulliGLM(N, B=B, L=L, seed=1,
                                            device="cpu")
    pm.add_data(_data("bernoulli")[:L - 2])
    assert pm.forecast(4, n_samples=1, thin=0).shape == (1, 4, N)


def test_ring0_continues_from_history_as_jax():
    jm, pm, Y = _pair("bernoulli")
    ring0 = Y[-L:]
    key = jax.random.key(9)
    T_ahead = 40
    Yj, psij = jm._generate(key, jm.state, jm.basis, T=T_ahead,
                            ring0=ring0)
    U = np.stack([np.asarray(jax.random.uniform(k, (1, N)))[0]
                  for k in jax.random.split(key, T_ahead)])
    Yp, psip = pm._generate(None, pm.state, pm.basis, T_ahead,
                            uniforms=torch.from_numpy(U),
                            ring0=torch.from_numpy(ring0))
    np.testing.assert_allclose(psip[0].numpy(), np.asarray(psij)[0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(Yp.numpy(), np.asarray(Yj))
    # The history matters: from silence the first bin's psi is the bias.
    _, psi0 = pm._generate(None, pm.state, pm.basis, 1,
                           uniforms=torch.from_numpy(U[:1]))
    np.testing.assert_allclose(psi0[0].numpy(), pm.bias, rtol=1e-6)
    assert not np.allclose(psip[0].numpy(), pm.bias)
