"""Carry a chain state between the JAX package and the port as numpy
arrays, so both packages can be set to exactly the same state."""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import GaussianWeightsState
from pyglm_tpu_torch.models.sweep import GLMState


def state_from_numpy(A, W, b, net, device="cpu") -> GLMState:
    """GLMState from numpy arrays: A (N, N), W (N, N, B), b (N,) go to
    `device`; net = (mu (B,), Sigma (B, B), rho ()) stays on the host, where
    the port keeps the network state. ``tuple(jax_state.net)`` of a JAX
    Erdos-Renyi state is such a triple."""
    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    mu, Sigma, rho = (torch.tensor(np.asarray(x, np.float32)) for x in net)
    return GLMState(dev(A), dev(W), dev(b), None,
                    GaussianWeightsState(mu, Sigma, rho))


def state_to_numpy(state: GLMState) -> dict:
    """{'A', 'W', 'b', 'net': (mu, Sigma, rho)} as float32 numpy arrays."""
    return {"A": state.A.cpu().numpy(), "W": state.W.cpu().numpy(),
            "b": state.b.cpu().numpy(),
            "net": tuple(x.cpu().numpy() for x in state.net)}
