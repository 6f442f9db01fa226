"""Posterior parity of the port against its f64 NumPy oracle on the CPU
under the stochastic block model (tests/test_numpy_parity.py:313, through
pyglm_tpu_torch/diagnostics/parity.py::ORACLE_CONFIGS): the sequential
label scan, Dirichlet pi, Beta block rho and per-block NIW. Its data,
priors and tolerances (the oracle given the models' bias prior), cut to
one chain a side of 150 + 400 sweeps. The compared functionals are
label-permutation invariant (edge marginals, W_effective, bias, density,
the mean block rho)."""
import torch

from pyglm_tpu_torch.diagnostics import parity as par

torch.set_num_threads(1)


def test_port_matches_oracle_sbm():
    r, _ = par.config_parity("sbm", sweeps=(150, 400), n_chains=1)
    assert par.config_gates("sbm", r), (r, par.ORACLE_CONFIGS["sbm"].tol)
