"""Carry a chain state between the JAX package and the port as numpy
arrays, so both packages can be set to exactly the same state."""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import GaussianWeightsState
from pyglm_tpu_torch.models.sweep import GLMState


def state_from_numpy(A, W, b, net, device="cpu", aux=None) -> GLMState:
    """GLMState from numpy arrays: A (N, N), W (N, N, B), b (N,) go to
    `device`; net = (mu (B,), Sigma (B, B), rho ()) stays on the host, where
    the port keeps the network state. ``tuple(jax_state.net)`` of a JAX
    Erdos-Renyi state is such a triple. `aux` is the family's aux as a dict
    of arrays ({'r': (N,)} for NB, as the JAX state holds it) or None."""
    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    mu, Sigma, rho = (torch.tensor(np.asarray(x, np.float32)) for x in net)
    aux = None if aux is None else {k: dev(v) for k, v in aux.items()}
    return GLMState(dev(A), dev(W), dev(b), aux,
                    GaussianWeightsState(mu, Sigma, rho))


def state_to_numpy(state: GLMState) -> dict:
    """{'A', 'W', 'b', 'net': (mu, Sigma, rho), 'aux'} as float32 numpy
    arrays; 'aux' is a dict of arrays or None."""
    aux = (None if state.aux is None else
           {k: v.cpu().numpy() for k, v in state.aux.items()})
    return {"A": state.A.cpu().numpy(), "W": state.W.cpu().numpy(),
            "b": state.b.cpu().numpy(),
            "net": tuple(x.cpu().numpy() for x in state.net), "aux": aux}
