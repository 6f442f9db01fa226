"""utils/convert.py: a JAX chain state of each network prior and each
family's aux, carried into the port by state_from_numpy (dispatched on the
prior, the SBM's labels kept integer), gives the JAX model's
log-likelihood on the same data (rtol 1e-5); state_to_numpy then
state_from_numpy round-trips it exactly."""
import numpy as np
import jax
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)
N, B, L, T = 6, 2, 4, 400
CASES = [("erdos_renyi", "bernoulli"), ("latent_distance", "bernoulli"),
         ("dense", "bernoulli"), ("sbm", "bernoulli"),
         ("erdos_renyi", "negative_binomial"), ("dense", "gaussian"),
         ("sbm", "binomial")]


def _data(family, rng):
    if family == "negative_binomial":
        return rng.negative_binomial(3, 0.6, (T, N)).astype(np.float32)
    if family == "binomial":
        return rng.integers(0, 4, (T, N)).astype(np.float32)
    if family == "gaussian":
        return rng.standard_normal((T, N)).astype(np.float32)
    return (rng.random((T, N)) < 0.2).astype(np.float32)


def _kw(network, family):
    kw = dict(B=B, L=L, network=network, observation=family,
              spike_and_slab=network != "dense")
    if family == "binomial":
        kw["obs_kwargs"] = dict(n_trials=3)
    if network == "sbm":
        kw["net_kwargs"] = dict(K=3)
    return kw


@pytest.mark.parametrize("network,family", CASES)
def test_jax_state_carries_over(network, family):
    rng = np.random.default_rng(0)
    jm = pyglm_tpu.NonlinearAutoregressiveModel(N, seed=1,
                                                **_kw(network, family))
    s = jm.state
    if isinstance(s.aux, dict):      # move aux off its initial value
        s = s._replace(aux={k: v * 1.3 for k, v in s.aux.items()})
        jm.state = s
    pm = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        N, seed=1, device="cpu", **_kw(network, family))
    aux = (None if s.aux is None else
           {k: np.asarray(v) for k, v in s.aux.items()})
    pm.state = state_from_numpy(
        np.asarray(s.A), np.asarray(s.W), np.asarray(s.b),
        tuple(np.asarray(x) for x in s.net), device="cpu", aux=aux,
        network=pm.network)
    assert type(pm.state.net).__name__ == type(s.net).__name__
    if network == "sbm":
        assert pm.state.net.c.dtype == torch.int64
        np.testing.assert_array_equal(pm.state.net.c.numpy(),
                                      np.asarray(s.net.c))
    Y = _data(family, rng)
    np.testing.assert_allclose(pm.log_likelihood(Y), jm.log_likelihood(Y),
                               rtol=1e-5)

    x = state_to_numpy(pm.state)
    back = state_to_numpy(state_from_numpy(x["A"], x["W"], x["b"], x["net"],
                                           device="cpu", aux=x["aux"],
                                           network=network))
    for k in ("A", "W", "b"):
        np.testing.assert_array_equal(back[k], x[k])
    for got, want in zip(back["net"], x["net"], strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (back["aux"] is None) == (x["aux"] is None)
    for k in x["aux"] or {}:
        np.testing.assert_array_equal(back["aux"][k], x["aux"][k])
