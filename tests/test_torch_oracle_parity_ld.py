"""Posterior parity of the port against its f64 NumPy oracle on the CPU
under the latent-distance prior (tests/test_numpy_parity.py:405, through
pyglm_tpu_torch/diagnostics/parity.py::ORACLE_CONFIGS): the port's HMC
with swap and relocation moves against the oracle's random-walk
Metropolis, another exact algorithm. Its data, priors and tolerances (the
oracle given the models' bias prior) and two chains a side, cut to 100 +
300 sweeps; the port's two chains run as one lane-stacked sweep. The
compared functionals are rotation and reflection invariant (edge
marginals, W_effective, bias, density, gamma)."""
import torch

from pyglm_tpu_torch.diagnostics import parity as par

torch.set_num_threads(1)


def test_port_matches_oracle_latent_distance():
    r, _ = par.config_parity("latent_distance", sweeps=(100, 300),
                             stacked=True)
    assert par.config_gates("latent_distance", r), (
        r, par.ORACLE_CONFIGS["latent_distance"].tol)
