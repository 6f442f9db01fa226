"""The slice as a whole: pyglm_tpu_torch.SparseBernoulliGLM against
pyglm_tpu.SparseBernoulliGLM on the CPU (N=10, T=3000, B=4, L=10, G=5).

(a) log-likelihood parity at the same state (rtol 1e-5);
(b) generation from the same state with JAX's uniforms injected: same Y;
(c) both packages fit the same Y from the same initial state (50 burn-in +
    150 kept sweeps) and must agree on the posterior;
(d) configurations beyond the slice (dense sweeps, the Gaussian family,
    the SBM prior) construct and run a sweep, and what the port does not
    run yet (chain meshes) raises NotImplementedError.
Every port model here is built with device="cpu".
"""
import numpy as np
import jax
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch
from pyglm_tpu.utils.metrics import link_auc as link_auc_jax
from pyglm_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from pyglm_tpu_torch.utils.metrics import link_auc

torch.set_num_threads(1)
N, T, B, L, G = 10, 3000, 4, 10, 5
TRUTH = dict(rho_init=0.25, learn_rho=False, mu_bias=-1.5, sigma_bias=0.25,
             learn_weight_prior=False, sigma_w=1.0)

# Chain-level gates of (c). Calibrated over seeds 0-4: the worst values
# seen were a mean |diff| of the edge marginals of 0.077, a link AUC of
# 0.916 and a relative gap in the mean edge count of 9.0%. Twice those
# (0.15, 0.83, 18%) would be looser than the gates below, which all five
# seeds met, so the tighter gates are kept; the test runs seed 0 (0.025,
# AUC 0.95/0.96, gap 0.7%).
MAX_MEAN_DIFF = 0.1
MIN_AUC = 0.9
MAX_EDGE_GAP = 0.1


def _truth_and_data(seed):
    truth = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=1000 + seed,
                                         net_kwargs=TRUTH)
    return truth, truth.generate(T, keep=False)


def _port_like(jm, seed):
    """A port model on the CPU set to the JAX model's exact state."""
    pm = pyglm_tpu_torch.SparseBernoulliGLM(N, B=B, L=L, seed=seed, group=G,
                                            device="cpu")
    s = jm.state
    pm.state = state_from_numpy(np.asarray(s.A), np.asarray(s.W),
                                np.asarray(s.b),
                                tuple(np.asarray(x) for x in s.net),
                                device="cpu", network=pm.network)
    return pm


def test_log_likelihood_parity():
    truth, Y = _truth_and_data(0)
    jm = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=3)
    jm.add_data(Y)
    pm = _port_like(jm, 3)
    pm.add_data(Y)
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-5)
    np.testing.assert_allclose(pm.log_likelihood(Y[:500]),
                               jm.log_likelihood(Y[:500]), rtol=1e-5)


def test_two_datasets_log_likelihood_parity_and_sweep():
    """Datasets concatenate along time without mixing their histories."""
    _, Y = _truth_and_data(2)
    jm = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=5)
    pm = _port_like(jm, 5)
    for m in (jm, pm):
        m.add_data(Y[:1200])
        m.add_data(Y[1200:])
    np.testing.assert_allclose(pm.log_likelihood(), jm.log_likelihood(),
                               rtol=1e-5)
    diag = pm.resample_model()
    assert np.isfinite(diag["log_likelihood"])
    np.testing.assert_allclose(diag["log_likelihood"], pm.log_likelihood(),
                               rtol=1e-4)


def test_state_round_trip():
    jm = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=4)
    pm = _port_like(jm, 4)
    back = state_to_numpy(pm.state)
    np.testing.assert_array_equal(back["W"], np.asarray(jm.state.W))
    for got, ref in zip(back["net"], jm.state.net):
        np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(pm.A, np.asarray(jm.state.A))


def test_generate_matches_jax_with_injected_uniforms():
    truth, _ = _truth_and_data(1)
    key = jax.random.key(7)
    Y_ref, _ = truth._generate(key, truth.state, truth.basis, T=T)
    # JAX's per-bin Bernoulli draw is uniform(k_t, (1, N)) < p.
    U = np.stack([np.asarray(jax.random.uniform(k, (1, N)))[0]
                  for k in jax.random.split(key, T)])
    pm = _port_like(truth, 1)
    Y, _ = pm._generate(None, pm.state, pm.basis, T,
                        uniforms=torch.from_numpy(U))
    Y = Y.numpy()
    assert 0.02 < Y.mean() < 0.5
    np.testing.assert_array_equal(Y, np.asarray(Y_ref))


# aten calls that only make views: no kernel runs for them.
_VIEWS = {"select", "slice", "view", "unsqueeze", "squeeze", "squeeze_",
          "permute", "t", "transpose", "expand", "as_strided", "alias",
          "_unsafe_view", "detach", "reshape"}


def test_generate_launches_ten_kernels_a_bin():
    """A Bernoulli bin of the per-bin generation loop runs 10 kernels: the
    two GEMMs, the bias add into psi's row, the draw (logistic's neg, exp,
    add and reciprocal, the compare, the cast) and one copy into the
    output. Counted as the aten calls that are not views, the calls of
    T=20 bins less those of T=10, over 10."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func.__name__.split(".")[0] not in _VIEWS
            return func(*args, **(kwargs or {}))

    pm = pyglm_tpu_torch.SparseBernoulliGLM(N, B=B, L=L, seed=2,
                                            device="cpu")
    calls = []
    for t in (10, 20):
        with Calls() as c:
            pm._generate(torch.Generator().manual_seed(0), pm.state,
                         pm.basis, t)
        calls.append(c.n)
    assert (calls[1] - calls[0]) / 10 == 10, calls


def test_posterior_agrees_with_jax():
    seed = 0
    truth, Y = _truth_and_data(seed)
    jm = pyglm_tpu.SparseBernoulliGLM(N, B=B, L=L, seed=seed)
    jm.add_data(Y)
    pm = _port_like(jm, seed)
    pm.add_data(Y)
    rj = jm.fit(n_samples=150, n_burnin=50)
    rp = pm.fit(n_samples=150, n_burnin=50)
    assert rp["A"].shape == (150, N, N) and rp["W"].shape == (150, N, N, B)
    assert np.isfinite(rp["lls"]).all()
    Pj, Pp = rj["A"].mean(0), rp["A"].mean(0)
    assert np.abs(Pj - Pp).mean() <= MAX_MEAN_DIFF
    assert link_auc(Pp, truth.A) >= MIN_AUC
    assert link_auc_jax(Pj, truth.A) >= MIN_AUC
    ej, ep = rj["A"].sum((1, 2)).mean(), rp["A"].sum((1, 2)).mean()
    assert abs(ep - ej) <= MAX_EDGE_GAP * ej


@pytest.mark.parametrize("kw", [
    dict(observation="negative_binomial", network="sbm"),
    dict(observation="gaussian"),
    dict(observation="binomial", network="sbm"), dict(network="dense"),
    dict(network="sbm"), dict(network="latent_distance", spike_and_slab=False),
    dict(network="erdos_renyi", spike_and_slab=False)])
def test_unported_configurations_raise(kw):
    cls = (pyglm_tpu_torch.NonlinearAutoregressiveModel
           if "spike_and_slab" in kw else pyglm_tpu_torch.SparseBernoulliGLM)
    m = cls(N, B=B, L=L, device="cpu", **kw)
    Y = (np.random.default_rng(0).random((600, N)) < 0.2).astype(np.float32)
    m.add_data(Y)
    assert np.isfinite(m.resample_model()["log_likelihood"])
    with pytest.raises(NotImplementedError):
        m.fit_ensemble(n_chains=2, n_samples=4, mesh=object())


def test_link_auc_matches_jax_metric():
    rng = np.random.default_rng(0)
    s = np.round(rng.random((N, N)), 1)           # ties exercise midranks
    A = rng.random((N, N)) < 0.3
    assert link_auc(s, A) == pytest.approx(link_auc_jax(s, A), abs=1e-12)
