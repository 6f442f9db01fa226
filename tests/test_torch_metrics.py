"""The port's predictive metrics (pyglm_tpu_torch/utils/metrics.py) against
the JAX package's: bits_per_spike equals JAX's exactly on the same inputs;
predictive_log_likelihood matches JAX's (rtol 1e-5) on the same state and
held-out Y when no sweep runs between the samples (thin=0), and with
thin=1 it advances the chain and returns one finite value per sample.
"""
import numpy as np
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu.utils import metrics as jmet
from pyglm_tpu_torch.utils import metrics as tmet
from pyglm_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(1)
N, B, L = 5, 2, 4


@pytest.mark.parametrize("seed,rate,baseline", [
    (0, 0.05, None), (1, 0.3, None), (2, 0.1, 0.07), (3, 0.0, None)])
def test_bits_per_spike_matches_jax(seed, rate, baseline):
    rng = np.random.default_rng(seed)
    Y = (rng.random((400, N)) < rate).astype(np.float32)
    pll = float(rng.normal(-500.0, 50.0))
    assert (tmet.bits_per_spike(pll, Y, baseline)
            == jmet.bits_per_spike(pll, Y, baseline))


def _pair():
    rng = np.random.default_rng(8)
    Y = (rng.random((600, N)) < 0.2).astype(np.float32)
    Y_test = (rng.random((200, N)) < 0.2).astype(np.float32)
    jm = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=2)
    jm.add_data(Y)
    jm.resample_model()
    pm = pyglm_tpu_torch.SparseBernoulliGLM(N, B=B, L=L, seed=2,
                                            device="cpu")
    s = jm.state
    pm.state = state_from_numpy(np.asarray(s.A), np.asarray(s.W),
                                np.asarray(s.b),
                                tuple(np.asarray(x) for x in s.net),
                                device="cpu", network=pm.network)
    pm.add_data(Y)
    return jm, pm, Y_test


def test_predictive_log_likelihood_matches_jax():
    jm, pm, Y_test = _pair()
    pj, llj = jmet.predictive_log_likelihood(jm, Y_test, n_samples=3,
                                             thin=0)
    pp, llp = tmet.predictive_log_likelihood(pm, Y_test, n_samples=3,
                                             thin=0)
    assert llp.shape == (3,)
    np.testing.assert_allclose(llp, llj, rtol=1e-5)
    np.testing.assert_allclose(pp, pj, rtol=1e-5)
    np.testing.assert_allclose(tmet.bits_per_spike(pp, Y_test),
                               jmet.bits_per_spike(pj, Y_test), rtol=1e-4)


def test_predictive_log_likelihood_advances_the_chain():
    _, pm, Y_test = _pair()
    b0 = pm.bias.copy()
    pll, lls = tmet.predictive_log_likelihood(pm, Y_test, n_samples=4)
    assert lls.shape == (4,) and np.isfinite(lls).all()
    assert lls.max() >= pll >= lls.min() - 1e-6
    assert not np.array_equal(pm.bias, b0)
