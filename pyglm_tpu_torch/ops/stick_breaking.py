"""Stick-breaking transforms for PG-augmented multinomial models (PyTorch
counterpart of ``pyglm_tpu/ops/stick_breaking.py``): a K-way categorical
as K-1 dependent binomial sticks, psi_k the k-th stick's logit, each of
which takes the standard PG augmentation.

The transforms act on tensors (any device) and return tensors;
:func:`compute_psi_cmoments` is numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.utils.utils import logistic, logit


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x, np.float32))


def psi_to_pi(psi):
    """(..., K-1) stick logits -> (..., K) simplex probabilities:
    pi_k = sigma(psi_k) prod_{j<k} (1 - sigma(psi_j)), pi_K the rest."""
    psi = _t(psi)
    sig = logistic(psi)
    log_rem = torch.cumsum(torch.log1p(-sig), dim=-1)
    log_rem_excl = torch.cat([torch.zeros_like(log_rem[..., :1]),
                              log_rem[..., :-1]], dim=-1)
    return torch.cat([sig * torch.exp(log_rem_excl),
                      torch.exp(log_rem[..., -1:])], dim=-1)


def pi_to_psi(pi):
    """The inverse of :func:`psi_to_pi`: (..., K) simplex -> (..., K-1)
    logits."""
    pi = _t(pi)
    cum = torch.cumsum(pi, dim=-1)
    rem = 1.0 - torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-2]],
                          dim=-1)
    frac = pi[..., :-1] / torch.clamp(rem, min=1e-12)
    return logit(torch.clamp(frac, 1e-12, 1.0 - 1e-12))


def N_vec(y):
    """The sticks' PG trial counts for multinomial counts y (..., K):
    N_k = sum_j y_j - sum_{j<k} y_j, k = 1 .. K-1."""
    y = _t(y)
    total = torch.sum(y, dim=-1, keepdim=True)
    cum = torch.cumsum(y, dim=-1)
    cum_excl = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                         dim=-1)
    return (total - cum_excl)[..., :-1]


def kappa_vec(y):
    """The sticks' kappa: kappa_k = y_k - N_k / 2."""
    y = _t(y)
    return y[..., :-1] - 0.5 * N_vec(y)


def compute_psi_cmoments(alphas):
    """Mean and variance of the stick logits implied by a Dirichlet(alphas)
    prior on pi, by Monte Carlo over 20000 draws (numpy seed 0): for
    setting the Gaussian prior moments of stick-breaking logits."""
    alphas = np.asarray(alphas, float)
    pis = np.random.RandomState(0).dirichlet(alphas, size=20_000)
    psis = pi_to_psi(torch.as_tensor(pis, dtype=torch.float32)).numpy()
    return psis.mean(0), psis.var(0)
