"""End-to-end posterior parity of the port against its f64 NumPy oracle
(pyglm_tpu_torch/reference/numpy_ref.py): two independently written
samplers of the same posterior must agree on posterior functionals within
Monte Carlo tolerance. The protocol and tolerances of
tests/test_numpy_parity.py's Bernoulli-ER config (N=5, B=2, L=4, T=1500,
150 + 400 sweeps, one chain each; max differences of the posterior means:
edge marginals < 0.22, W_effective < 0.35, biases < 0.25, mean edge
probability < 0.06), with the port's sweep on the CPU (~30 s, most of it
the oracle's).

A second, shorter case is stated the same way: T=750, 100 + 250 sweeps,
the port's posterior pooled over 4 lane-stacked chains (fit_ensemble)
against one oracle chain, at the same four tolerances.
"""
import numpy as np
import torch

from pyglm_tpu_torch import SparseBernoulliGLM
from pyglm_tpu_torch.diagnostics.parity import posterior_means
from pyglm_tpu_torch.ops.basis import cosine_basis
from pyglm_tpu_torch.reference.numpy_ref import NumpyGLMReference

torch.set_num_threads(1)
N, B, L = 5, 2, 4
RHO, SIGMA_W, MU_B, SIGMA_B = 0.35, 0.8, -1.2, 0.4
NET = dict(rho_init=RHO, learn_rho=False, mu_bias=MU_B, sigma_bias=SIGMA_B,
           learn_weight_prior=False, sigma_w=SIGMA_W)
TOL = {"A": 0.22, "W": 0.35, "b": 0.25, "density": 0.06}


def _data(T):
    """The planted model of tests/test_numpy_parity.py (seed 123), by the
    port's generator on the CPU."""
    basis = cosine_basis(B=B, L=L)
    Y = SparseBernoulliGLM(N, basis=basis, seed=123, net_kwargs=NET,
                           device="cpu").generate(T, keep=False)
    return basis, Y.astype(np.float64)


def _oracle(basis, Y, n_burn, n_keep, seed=7):
    # The oracle's sigma_b is a variance, the models' sigma_bias a standard
    # deviation (diagnostics/parity.py::oracle_chain).
    ref = NumpyGLMReference(N=N, B=B, basis=basis, rho=RHO, mu_w=0.0,
                            sigma_w=SIGMA_W, mu_b=MU_B, sigma_b=SIGMA_B ** 2,
                            seed=seed)
    return posterior_means(ref, Y, n_burn, n_keep)


def _check(port, oracle):
    (A1, W1, b1), (A2, W2, b2) = port, oracle
    assert np.max(np.abs(b1 - b2)) < TOL["b"], (b1, b2)
    assert np.max(np.abs(A1 - A2)) < TOL["A"], np.max(np.abs(A1 - A2))
    assert np.max(np.abs(W1 - W2)) < TOL["W"], np.max(np.abs(W1 - W2))
    assert abs(A1.mean() - A2.mean()) < TOL["density"]


def test_posterior_means_match_oracle():
    basis, Y = _data(1500)
    n_burn, n_keep = 150, 400
    model = SparseBernoulliGLM(N, basis=basis, seed=0, net_kwargs=NET,
                               device="cpu")
    model.add_data(Y)
    A1 = np.zeros((N, N)); W1 = np.zeros((N, N)); b1 = np.zeros(N)
    for it in range(n_burn + n_keep):
        model.resample_model()
        if it >= n_burn:
            A1 += model.A / n_keep
            W1 += model.W_effective / n_keep
            b1 += model.bias / n_keep
    _check((A1, W1, b1), _oracle(basis, Y, n_burn, n_keep))


def test_posterior_means_match_oracle_pooled_short():
    basis, Y = _data(750)
    n_burn, n_keep = 100, 250
    model = SparseBernoulliGLM(N, basis=basis, seed=0, net_kwargs=NET,
                               device="cpu")
    model.add_data(Y)
    out = model.fit_ensemble(n_chains=4, n_burnin=n_burn, n_samples=n_keep)
    port = (out["A"].mean((0, 1)), out["W"].sum(-1).mean((0, 1)),
            out["bias"].mean((0, 1)))
    _check(port, _oracle(basis, Y, n_burn, n_keep))
