"""Carry a chain state between the JAX package and the port as numpy
arrays, so both packages can be set to exactly the same state. Every array
may carry a leading chain axis: a stacked (C-leading) state of the JAX
ensemble converts as it is."""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import (
    GaussianWeightsState, LatentDistanceState, SBMState, network_name,
)
from pyglm_tpu_torch.models.sweep import GLMState
from pyglm_tpu_torch.utils.utils import require_device


def state_from_numpy(A, W, b, net, device="cuda", aux=None, *,
                     network) -> GLMState:
    """GLMState from numpy arrays: A (N, N), W (N, N, B), b (N,) go to
    `device` as float32. `net` is ``tuple(jax_state.net)`` of the prior
    `network` (its config or name), which says how to read it:

    - 'dense', 'erdos_renyi': (mu (B,), Sigma (B, B), rho ()), on the host;
    - 'sbm': (c (N,), pi (K,), rho (K, K), mu (K, K, B), Sigma
      (K, K, B, B)), on the host, the labels c as int64;
    - 'latent_distance': (L (N, dim), gamma (), mu, Sigma[, hmc_accept
      ()]); L, gamma and hmc_accept go to `device`.

    `aux` is the family's aux as a dict of arrays ({'r': (N,)} for NB,
    {'eta': (N,)} for the Gaussian, as the JAX state holds it) or None."""
    device = require_device(device)

    def dev(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def host(x):
        return torch.tensor(np.asarray(x, np.float32))

    aux = None if aux is None else {k: dev(v) for k, v in aux.items()}
    kind = network_name(network)
    if kind in ("dense", "erdos_renyi"):
        net = GaussianWeightsState(*map(host, net))
    elif kind == "sbm":
        c, *rest = net
        net = SBMState(torch.tensor(np.asarray(c, np.int64)),
                       *map(host, rest))
    else:
        L, gamma, mu, Sigma = net[:4]
        acc = net[4] if len(net) > 4 else np.zeros(np.shape(gamma))
        net = LatentDistanceState(dev(L), dev(gamma), host(mu), host(Sigma),
                                  dev(acc))
    return GLMState(dev(A), dev(W), dev(b), aux, net)


def state_to_numpy(state: GLMState) -> dict:
    """{'A', 'W', 'b', 'net', 'aux'} as numpy arrays (float32, the SBM's
    labels int64): 'net' is the network state's fields in order, 'aux' a
    dict of arrays or None. ``state_from_numpy`` with the prior restores
    it exactly."""
    aux = (None if state.aux is None else
           {k: v.cpu().numpy() for k, v in state.aux.items()})
    return {"A": state.A.cpu().numpy(), "W": state.W.cpu().numpy(),
            "b": state.b.cpu().numpy(),
            "net": tuple(x.cpu().numpy() for x in state.net), "aux": aux}
