"""Checkpoint and resume (pyglm_tpu_torch/utils/checkpoint.py) on the CPU.

Run k sweeps, save, run m more; then load the file into a fresh model of
the same configuration (another seed) and run m more: the two runs are
bit-identical (A, W, b, aux and the network state equal, and the
log-likelihoods), for each family with an aux and each prior whose state
holds integers, host and device tensors. Loading into a model of another
N, B, family, prior or spike-and-slab setting raises ValueError.
"""
import pytest
import torch

import pyglm_tpu_torch as pt
from pyglm_tpu_torch.utils.checkpoint import load_state, save_state

torch.set_num_threads(1)
K_SWEEPS, M_SWEEPS = 3, 4
NB_NET = dict(rho_init=0.2, learn_rho=False, mu_bias=-2.5, sigma_bias=0.1,
              sigma_w=0.05, learn_weight_prior=False)
CONFIGS = {
    "bernoulli_er": dict(network="erdos_renyi", spike_and_slab=True),
    "nb_er": dict(observation="negative_binomial", network="erdos_renyi",
                  spike_and_slab=True, net_kwargs=NB_NET,
                  obs_kwargs=dict(max_y=64)),
    "gaussian_dense": dict(observation="gaussian", network="dense",
                           net_kwargs=dict(sigma_w=0.05, mu_bias=0.0)),
    "sbm": dict(network="sbm", spike_and_slab=True, net_kwargs=dict(K=2)),
    "latent_distance": dict(network="latent_distance", spike_and_slab=True,
                            net_kwargs=dict(dim=2)),
}


def _model(name, seed, N=6):
    return pt.NonlinearAutoregressiveModel(N, B=2, L=4, seed=seed,
                                           device="cpu", **CONFIGS[name])


def _state(m):
    st = m.state
    return [st.A, st.W, st.b, *(st.aux or {}).values(), *st.net]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_resume_is_bit_identical(name, tmp_path):
    m = _model(name, seed=0)
    Y = m.generate(300, keep=True)
    for _ in range(K_SWEEPS):
        m.resample_model()
    path = tmp_path / "chain.npz"
    save_state(path, m)
    ll_a = [m.resample_model()["log_likelihood"] for _ in range(M_SWEEPS)]
    r = _model(name, seed=5)
    r.add_data(Y)
    load_state(path, r)
    ll_b = [r.resample_model()["log_likelihood"] for _ in range(M_SWEEPS)]
    assert ll_a == ll_b
    for x, y in zip(_state(m), _state(r)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("other", [
    dict(N=7), dict(B=3), dict(observation="binomial"),
    dict(network="dense"), dict(spike_and_slab=False),
])
def test_load_into_another_configuration_raises(other, tmp_path):
    kw = dict(N=6, B=2, observation="bernoulli", network="erdos_renyi",
              spike_and_slab=True)
    m = pt.NonlinearAutoregressiveModel(kw.pop("N"), L=4, device="cpu", **kw)
    path = tmp_path / "chain.npz"
    save_state(path, m)
    kw2 = dict(N=6, B=2, observation="bernoulli", network="erdos_renyi",
               spike_and_slab=True) | other
    with pytest.raises(ValueError, match="another configuration"):
        load_state(path, pt.NonlinearAutoregressiveModel(
            kw2.pop("N"), L=4, device="cpu", **kw2))
