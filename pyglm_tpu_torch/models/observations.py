"""Observation families (PyTorch counterpart of
``pyglm_tpu/models/observations.py``; this slice ports ``Bernoulli``).

A family maps data to the PG-augmented conditionally-Gaussian form
likelihood(psi) prop-to exp(kappa psi - omega psi^2 / 2), omega ~ PG(b, psi).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pyglm_tpu_torch.ops.polyagamma import pg_draw_unit
from pyglm_tpu_torch.utils.utils import logistic, softplus


@dataclass(frozen=True)
class Bernoulli:
    """y ~ Bern(logistic(psi)); kappa = y - 1/2, b_pg = 1 (exact Devroye)."""
    name: str = "bernoulli"

    def init_aux(self, N: int):
        return None

    def omega_kappa(self, generator: torch.Generator, Y, psi, aux):
        """omega ~ PG(1, psi) (kernel K1 on the card), kappa = y - 1/2."""
        return pg_draw_unit(psi, generator), Y - 0.5

    def log_likelihood(self, Y, psi, aux):
        return Y * psi - softplus(psi)

    def log_likelihood_sum(self, Y, psi, aux):
        return torch.sum(self.log_likelihood(Y, psi, aux))

    def sample_from_uniform(self, U, psi, aux):
        """y = 1[U < logistic(psi)] for uniforms U, as a float32 tensor."""
        return (U < logistic(psi)).to(torch.float32)

    def resample_aux(self, generator, aux, Y, psi):
        return aux


def make_observation(name: str, **kwargs):
    name = name.lower()
    if name == "bernoulli":
        return Bernoulli(**kwargs)
    if name in ("binomial", "negative_binomial", "nb", "negbin", "gaussian"):
        raise NotImplementedError(
            f"observation family {name!r} is not ported to pyglm_tpu_torch "
            f"yet (ROADMAP.md Queue A, item 9)")
    raise ValueError(f"unknown observation family: {name}")
