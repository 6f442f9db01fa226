"""Posterior parity of the port against its f64 NumPy oracle on the CPU
(pyglm_tpu_torch/diagnostics/parity.py::ORACLE_CONFIGS): the dense path
with its learned NIW prior (tests/test_numpy_parity.py:560), the Gaussian
family on the cached Gram (:132) and the Binomial family (:218). The data,
priors and tolerances of those tests (the oracle given the models' bias
prior); the port's chains are single models (the Gaussian's sweep reads
its cached group Gram). Dense and Gaussian run the protocol's lengths and
chains; Binomial, whose oracle draws PG(3, c) as three Devroye draws, is
cut to one chain a side of 100 + 300 sweeps.
"""
import pytest
import torch

from pyglm_tpu_torch.diagnostics import parity as par

torch.set_num_threads(1)
# (burn, keep) or None for the protocol's; chains a side or None for all.
CASES = {"dense_niw": (None, None), "gaussian": (None, None),
         "binomial": ((100, 300), 1)}


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_oracle(name):
    sweeps, n = CASES[name]
    r, port = par.config_parity(name, sweeps=sweeps, n_chains=n)
    assert par.config_gates(name, r), (r, par.ORACLE_CONFIGS[name].tol)
    if name == "gaussian":
        # the noise posterior concentrates near the planted eta = 0.3
        eta = port["eta"].mean(0)
        assert ((eta > 0.15) & (eta < 0.6)).all(), eta
