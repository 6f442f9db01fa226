"""Network priors on (A, W) (PyTorch counterpart of
``pyglm_tpu/models/networks.py``; this slice ports the Erdos-Renyi prior).

A prior is a frozen config dataclass with

  init_state()                    -> hyperparameter state (host tensors)
  edge_hypers(state, device)      -> EdgeHypers on `device`
  resample(generator, state, A, W) -> new state (one Gibbs move)

The state is O(B^2) scalars: (mu (B,), Sigma (B, B), rho ()). It lives on
the host and its draws run there on a CPU generator; `resample` reduces the
(N, N) edge statistics on the device and brings back B^2 + B + 1 numbers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pyglm_tpu_torch.models.weights import EdgeHypers
from pyglm_tpu_torch.ops.linalg import (
    NIWParams, niw_posterior, sample_beta, sample_niw,
)
from pyglm_tpu_torch.utils.utils import expand_cov, expand_scalar, logit


class GaussianWeightsState(NamedTuple):
    mu: torch.Tensor      # (B,) shared weight prior mean
    Sigma: torch.Tensor   # (B, B) shared weight prior covariance
    rho: torch.Tensor     # () global connection probability


def _is_scalar(x) -> bool:
    return np.ndim(x) == 0


def _bias_hypers(cfg, N: int, device):
    """(mu_b, lam_b) (N,) each; mu_bias / sigma_bias are scalar or (N,)."""
    mu_b = torch.as_tensor(expand_scalar(cfg.mu_bias, (N,)), device=device)
    sig_b = torch.as_tensor(expand_scalar(cfg.sigma_bias, (N,)),
                            device=device)
    return mu_b, 1.0 / sig_b ** 2


def _fixed_weight_hypers(cfg):
    """Per-edge (mu, Lam) as host arrays for a fixed weight prior: mu_w is
    scalar | (B,) | (N,N,B); sigma_w (a variance) scalar | (B,) | (B,B) |
    (N,N,B,B)."""
    N, B = cfg.N, cfg.B
    mu = expand_scalar(cfg.mu_w, (N, N, B))
    Sig = expand_cov(cfg.sigma_w, (N, N, B, B))
    return mu, np.linalg.inv(Sig).astype(np.float32)


def _sigma_w_scalar(cfg) -> float:
    return float(np.asarray(cfg.sigma_w, np.float32).mean())


def _niw_params(cfg) -> NIWParams:
    B = cfg.B
    return NIWParams(
        mu0=torch.full((B,), cfg.niw_mu0, dtype=torch.float32),
        kappa0=torch.tensor(cfg.niw_kappa0, dtype=torch.float32),
        nu0=torch.tensor(cfg.niw_nu0 if cfg.niw_nu0 is not None else B + 2,
                         dtype=torch.float32),
        Psi0=torch.eye(B, dtype=torch.float32) * cfg.niw_psi0,
    )


def _masked_stats(W, mask):
    """(n, xbar, S) of the active-edge weights W[mask], reduced on W's
    device and returned on the host: count, mean (B,) and centered scatter
    (B, B). Inactive edges contribute 0, as in the JAX package."""
    B = W.shape[-1]
    m = mask[..., None]
    n = mask.sum()
    xbar = (m * W).sum(dim=(0, 1)) / torch.clamp(n, min=1e-12)
    diffs = (W - xbar) * m
    S = torch.einsum("ijb,ijc->bc", diffs, diffs)
    flat = torch.cat([n.reshape(1), xbar, S.reshape(-1)]).cpu()
    return flat[0], flat[1:1 + B], flat[1 + B:].reshape(B, B)


def _masked_niw_resample(generator, cfg, n, xbar, S):
    """(mu, Sigma) ~ NIW posterior given the active-edge statistics."""
    return sample_niw(generator, niw_posterior(_niw_params(cfg), n, xbar, S))


@dataclass(frozen=True)
class ErdosRenyiConfig:
    """Independent-Bernoulli sparsity: A_ij ~ Bern(rho), rho ~ Beta(a, b);
    shared (optionally NIW-learned) Gaussian weight prior on active edges."""
    N: int
    B: int
    a_rho: float = 1.0
    b_rho: float = 1.0
    rho_init: object = 0.25      # scalar | (N,N) per-edge (learn_rho=False)
    learn_rho: bool = True
    mu_bias: object = -2.0       # scalar | (N,)
    sigma_bias: object = 1.0     # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0           # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0        # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "erdos_renyi"

    def __post_init__(self):
        if self.learn_rho and not _is_scalar(self.rho_init):
            raise ValueError("per-edge rho_init requires learn_rho=False")
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False")

    @functools.cached_property
    def _fixed_hypers(self):
        return _fixed_weight_hypers(self)

    def init_state(self) -> GaussianWeightsState:
        return GaussianWeightsState(
            mu=torch.zeros((self.B,), dtype=torch.float32),
            Sigma=torch.eye(self.B, dtype=torch.float32)
            * _sigma_w_scalar(self),
            rho=torch.tensor(float(np.mean(self.rho_init)),
                             dtype=torch.float32),
        )

    def edge_hypers(self, state: GaussianWeightsState,
                    device) -> EdgeHypers:
        N, B = self.N, self.B
        if self.learn_weight_prior:
            Lam = torch.linalg.inv(state.Sigma.cpu()).to(device)
            mu = state.mu.to(device).expand(N, N, B)
            Lam = Lam.expand(N, N, B, B)
        else:
            mu, Lam = (torch.as_tensor(x, device=device)
                       for x in self._fixed_hypers)
        if self.learn_rho:
            rho = state.rho.cpu().expand(N, N)
        else:
            rho = torch.as_tensor(expand_scalar(self.rho_init, (N, N)))
        lrho = logit(torch.clamp(rho, 1e-5, 1.0 - 1e-5)).to(device)
        mu_b, lam_b = _bias_hypers(self, N, device)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def resample(self, generator: torch.Generator,
                 state: GaussianWeightsState, A, W) -> GaussianWeightsState:
        """rho ~ Beta(a + #edges, b + #non-edges), then (mu, Sigma) from the
        NIW posterior of the active weights; draws from the CPU
        `generator`."""
        n, xbar, S = _masked_stats(W, A)
        rho = state.rho
        if self.learn_rho:
            rho = sample_beta(self.a_rho + n, self.b_rho + A.numel() - n,
                              generator)
        mu, Sigma = state.mu, state.Sigma
        if self.learn_weight_prior:
            mu, Sigma = _masked_niw_resample(generator, self, n, xbar, S)
        return GaussianWeightsState(mu, Sigma, rho)


def make_network(name: str, N: int, B: int, **kwargs):
    name = name.lower()
    if name in ("erdos_renyi", "er", "independent", "sparse"):
        return ErdosRenyiConfig(N=N, B=B, **kwargs)
    if name in ("dense", "sbm", "stochastic_block", "latent_distance",
                "distance"):
        raise NotImplementedError(
            f"network prior {name!r} is not ported to pyglm_tpu_torch yet "
            f"(ROADMAP.md Queue A, items 8 and 10)")
    raise ValueError(f"unknown network prior: {name}")
