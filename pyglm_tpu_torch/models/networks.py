"""Network priors on (A, W) (PyTorch counterpart of
``pyglm_tpu/models/networks.py``: the dense, Erdos-Renyi, stochastic-block
and latent-distance priors).

A prior is a frozen config dataclass with

  init_state(gens, device)     -> hyperparameter state
  edge_hypers(state, device)   -> EdgeHypers on `device`
  resample(gens, state, A, W)  -> new state (one Gibbs move)

where `gens` are a model's ``Generators`` (models/sweep.py). The weight
prior's (mu (B,), Sigma (B, B)) and the ER rho live on the host and are
drawn there on the CPU generator: `resample` reduces the (N, N) edge
statistics on the device and brings back B^2 + B + 1 numbers. The SBM's
state (labels, block probabilities, per-block rho and NIW) lives on the
host too: its (K, K, N, N) edge tables are built where A and W live, cross
once per sweep, and the sequential label scan and the block draws run on
the host. The latent-distance positions live on the device, where their
HMC runs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pyglm_tpu_torch.models.weights import EdgeHypers
from pyglm_tpu_torch.ops.linalg import (
    NIWParams, logdet_from_chol, niw_posterior, sample_beta,
    sample_dirichlet, sample_niw,
)
from pyglm_tpu_torch.utils.utils import (
    expand_cov, expand_scalar, logit, softplus,
)


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
    device and returned on the host in one transfer: count, mean (B,) and
    centered scatter (B, B), per leading chain index if W is (C, N, N, B).
    Inactive edges contribute 0, as in the JAX package."""
    B = W.shape[-1]
    m = mask[..., None]
    n = mask.sum(dim=(-2, -1))
    xbar = (m * W).sum(dim=(-3, -2)) / torch.clamp(n, min=1e-12)[..., None]
    diffs = (W - xbar[..., None, None, :]) * m
    S = torch.einsum("...ijb,...ijc->...bc", diffs, diffs)
    flat = torch.cat([n[..., None], xbar, S.flatten(-2)], dim=-1).cpu()
    return (flat[..., 0], flat[..., 1:1 + B],
            flat[..., 1 + B:].reshape(*flat.shape[:-1], B, B))


def _masked_niw_resample(generator, cfg, n, xbar, S):
    """(mu, Sigma) ~ NIW posterior given the active-edge statistics."""
    return sample_niw(generator, niw_posterior(_niw_params(cfg), n, xbar, S))


def _weight_hypers(cfg, state, device):
    """Per-edge (mu (N, N, B), Lam (N, N, B, B)) on `device`: the learned
    shared prior of `state`, or the fixed prior of the config."""
    N, B = cfg.N, cfg.B
    if cfg.learn_weight_prior:
        Lam = torch.linalg.inv(state.Sigma.cpu()).to(device)
        return (state.mu.to(device).expand(N, N, B),
                Lam.expand(N, N, B, B))
    return tuple(torch.as_tensor(x, device=device)
                 for x in cfg._fixed_hypers)


@dataclass(frozen=True)
class DenseNetworkConfig:
    """All edges present (rho = 1); a shared NIW-learned Gaussian weight
    prior over all N^2 edges, or a fixed (optionally per-edge) one when
    learn_weight_prior=False."""
    N: int
    B: int
    mu_bias: object = -2.0       # scalar | (N,)
    sigma_bias: object = 1.0     # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0           # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0        # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "dense"

    def __post_init__(self):
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False")

    @functools.cached_property
    def _fixed_hypers(self):
        return _fixed_weight_hypers(self)

    def init_state(self, gens=None, device="cpu") -> GaussianWeightsState:
        """The fixed initial state (no draw; `gens` and `device` unused)."""
        return GaussianWeightsState(
            mu=torch.zeros((self.B,), dtype=torch.float32),
            Sigma=torch.eye(self.B, dtype=torch.float32)
            * _sigma_w_scalar(self),
            rho=torch.tensor(1.0, dtype=torch.float32))

    def edge_hypers(self, state: GaussianWeightsState,
                    device) -> EdgeHypers:
        """logit rho = 20 on every edge (rho = 1, clipped so that a
        spike-and-slab update configured with this prior stays finite)."""
        N = self.N
        mu, Lam = _weight_hypers(self, state, device)
        lrho = torch.full((N, N), 20.0, dtype=torch.float32, device=device)
        mu_b, lam_b = _bias_hypers(self, N, device)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def resample(self, gens, state: GaussianWeightsState, A,
                 W) -> GaussianWeightsState:
        """(mu, Sigma) from the NIW posterior of the weights of the edges
        in A (all of them under the dense sweep), on ``gens.host``."""
        if not self.learn_weight_prior:
            return state
        mu, Sigma = _masked_niw_resample(gens.host, self,
                                         *_masked_stats(W, A))
        return GaussianWeightsState(mu, Sigma, state.rho)


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

    def init_state(self, gens=None, device="cpu") -> GaussianWeightsState:
        """The fixed initial state (no draw; `gens` and `device` unused)."""
        return GaussianWeightsState(
            mu=torch.zeros((self.B,), dtype=torch.float32),
            Sigma=torch.eye(self.B, dtype=torch.float32)
            * _sigma_w_scalar(self),
            rho=torch.tensor(float(np.mean(self.rho_init)),
                             dtype=torch.float32),
        )

    def edge_hypers(self, state: GaussianWeightsState,
                    device) -> EdgeHypers:
        N = self.N
        mu, Lam = _weight_hypers(self, state, device)
        if self.learn_rho:
            rho = state.rho.cpu().expand(N, N)
        else:
            rho = torch.as_tensor(expand_scalar(self.rho_init, (N, N)))
        lrho = logit(torch.clamp(rho, 1e-5, 1.0 - 1e-5)).to(device)
        mu_b, lam_b = _bias_hypers(self, N, device)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def resample(self, gens, state: GaussianWeightsState, A,
                 W) -> GaussianWeightsState:
        """rho ~ Beta(a + #edges, b + #non-edges), then (mu, Sigma) from the
        NIW posterior of the active weights; draws from the CPU generator
        ``gens.host``. With both fixed it returns `state` and reads nothing
        back from the device."""
        if not (self.learn_rho or self.learn_weight_prior):
            return state
        generator = gens.host
        n, xbar, S = _masked_stats(W, A)
        rho = state.rho
        if self.learn_rho:
            rho = sample_beta(self.a_rho + n, self.b_rho + A.numel() - n,
                              generator)
        mu, Sigma = state.mu, state.Sigma
        if self.learn_weight_prior:
            mu, Sigma = _masked_niw_resample(generator, self, n, xbar, S)
        return GaussianWeightsState(mu, Sigma, rho)


class SBMState(NamedTuple):
    """Host tensors."""
    c: torch.Tensor       # (N,) int64 block labels
    pi: torch.Tensor      # (K,) block probabilities
    rho: torch.Tensor     # (K, K) block connection probabilities
    mu: torch.Tensor      # (K, K, B) block weight means
    Sigma: torch.Tensor   # (K, K, B, B) block weight covariances


@dataclass(frozen=True)
class SBMConfig:
    """Stochastic block model: c_n ~ Cat(pi), A_ij ~ Bern(rho[c_i, c_j]),
    W_ij ~ N(mu[c_i, c_j], Sigma[c_i, c_j]) on active edges; pi ~
    Dirichlet(alpha_pi), rho ~ Beta(a_rho, b_rho) and (mu, Sigma) ~ NIW
    per block pair.

    The labels are resampled by a sequential Gibbs scan over the neurons
    (labels interact through shared edges) that reads precomputed
    (K, K, N, N) edge log-likelihood tables, then pi, rho and the block
    NIWs given the new labels."""
    N: int
    B: int
    K: int = 5
    alpha_pi: float = 1.0
    a_rho: float = 1.0
    b_rho: float = 1.0
    mu_bias: float = -2.0
    sigma_bias: float = 1.0
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    sigma_w: float = 1.0
    rho_init: float = 0.25
    name: str = "sbm"

    def init_state(self, gens, device="cpu") -> SBMState:
        """Labels uniform over the K blocks from ``gens.host``; the block
        parameters at their fixed initial values."""
        N, B, K = self.N, self.B, self.K
        c = torch.randint(0, K, (N,), generator=gens.host)
        return SBMState(
            c=c, pi=torch.full((K,), 1.0 / K, dtype=torch.float32),
            rho=torch.full((K, K), self.rho_init, dtype=torch.float32),
            mu=torch.zeros((K, K, B), dtype=torch.float32),
            Sigma=(torch.eye(B, dtype=torch.float32)
                   * self.sigma_w).expand(K, K, B, B).contiguous())

    def edge_hypers(self, state: SBMState, device) -> EdgeHypers:
        """Each edge's block pair's (mu, Lambda, logit rho), gathered on
        `device` from the (K, K) tables."""
        ci = state.c.to(device)[:, None]
        cj = ci.T
        Lam = torch.linalg.inv(state.Sigma).to(device)
        lrho = logit(torch.clamp(state.rho, 1e-5, 1 - 1e-5)).to(device)
        mu_b, lam_b = _bias_hypers(self, self.N, device)
        return EdgeHypers(state.mu.to(device)[ci, cj], Lam[ci, cj],
                          lrho[ci, cj], mu_b, lam_b)

    def _edge_tables(self, state: SBMState, A, W):
        """tbl[x, y, i, j] = log Bern(A_ij; rho[x, y])
        + A_ij log N(W_ij; mu[x, y], Sigma[x, y]), (K, K, N, N) on A's
        device."""
        dev = A.device
        rho = torch.clamp(state.rho, 1e-5, 1 - 1e-5).to(dev)
        logB = (A * torch.log(rho)[:, :, None, None]
                + (1 - A) * torch.log1p(-rho)[:, :, None, None])
        Lam = torch.linalg.inv(state.Sigma).to(dev)            # (K,K,B,B)
        logdet = logdet_from_chol(torch.linalg.cholesky(state.Sigma)).to(dev)
        d = W - state.mu.to(dev)[:, :, None, None]            # (K,K,N,N,B)
        quad = torch.einsum("xyijb,xybc,xyijc->xyij", d, Lam, d)
        logN = -0.5 * (quad + logdet[:, :, None, None]
                       + self.B * math.log(2 * math.pi))
        return logB + A * logN

    @staticmethod
    def _label_logits(tbl_out, tbl_in, self_ll, log_pi, onehot):
        """The label conditional of one neuron n given the others' labels:
        log pi + its outgoing and incoming edges' log-likelihoods against
        the other neurons' labels + its self-edge's, which carries the
        candidate label on both ends. tbl_out[x, m k] = tbl[x, k, n, m],
        tbl_in[x, m k] = tbl[k, x, m, n], self_ll[x] = tbl[x, x, n, n];
        onehot (N K,) holds the labels with neuron n's row zeroed."""
        return log_pi + tbl_out @ onehot + tbl_in @ onehot + self_ll

    def _scan_tables(self, tbl):
        """The label scan's layouts of the edge tables (K, K, N, N), on
        their device: t_out[n, x, m K + k] = tbl[x, k, n, m], t_in[n, x,
        m K + k] = tbl[k, x, m, n] (the label scan's rows, contiguous) and
        self_ll[n, x] = tbl[x, x, n, n]."""
        K, N = self.K, self.N
        t_out = tbl.permute(2, 0, 3, 1).reshape(N, K, N * K)
        t_in = tbl.permute(3, 1, 2, 0).reshape(N, K, N * K)
        self_ll = torch.diagonal(torch.diagonal(tbl, dim1=2, dim2=3),
                                 dim1=0, dim2=1)                # (N, K)
        return t_out, t_in, self_ll

    def _label_scan(self, t_out, t_in, self_ll, c, pi, u):
        """The sequential Gibbs scan over the labels (numpy, float64): for
        n = 0 .. N-1, c_n ~ Cat(softmax(logits_n)) by the inverse CDF at
        u[n], given the labels drawn so far. t_out, t_in, self_ll as
        :meth:`_scan_tables` gives them; c (N,), pi (K,), u (N,)
        uniforms."""
        K, N = self.K, self.N
        log_pi = np.log(pi + 1e-12)
        onehot = np.zeros((N, K))
        onehot[np.arange(N), c] = 1.0
        oh = onehot.reshape(-1)
        c = c.copy()
        for n in range(N):
            onehot[n] = 0.0
            lg = self._label_logits(t_out[n], t_in[n], self_ll[n], log_pi,
                                    oh)
            cdf = np.cumsum(np.exp(lg - lg.max()))
            c[n] = min(int(np.searchsorted(cdf, u[n] * cdf[-1],
                                           side="right")), K - 1)
            onehot[n, c[n]] = 1.0
        return c

    def resample(self, gens, state: SBMState, A, W) -> SBMState:
        """The label scan on the host (its uniforms one (N,) draw from
        ``gens.host``), after one transfer of the edge tables (in the
        scan's layouts), A and W; then pi ~ Dirichlet(alpha_pi + counts),
        rho ~ Beta per block pair and each block pair's (mu, Sigma) from
        its NIW posterior over the active edges it holds, all on
        ``gens.host``. The block statistics are matrix products with the
        label indicators (float64); the scatter is the raw second moment
        less n xbar xbar'."""
        N, K, B = self.N, self.K, self.B
        g = gens.host
        parts = [*self._scan_tables(self._edge_tables(state, A, W)), A, W]
        sizes = [x.numel() for x in parts]
        host = torch.cat([x.reshape(-1) for x in parts]).cpu().double()
        t_out, t_in, self_ll, A_h, W_h = (
            x.reshape(p.shape) for x, p in zip(host.split(sizes), parts))
        u = torch.rand((N,), generator=g, dtype=torch.float64)
        c = torch.from_numpy(self._label_scan(
            t_out.numpy(), t_in.numpy(), self_ll.numpy(), state.c.numpy(),
            state.pi.double().numpy(), u.numpy()))
        Z = torch.nn.functional.one_hot(c, K).double()        # (N, K)
        n_k = Z.sum(0)
        pi = sample_dirichlet(self.alpha_pi + n_k.float(), g)
        n_act = Z.T @ A_h @ Z                                  # (K, K)
        rho = sample_beta((self.a_rho + n_act).float(),
                          (self.b_rho + n_k[:, None] * n_k[None, :]
                           - n_act).float(), g)

        def block_sums(X):          # (N, N, ...) -> (K, K, ...), A's edges
            return torch.einsum("ix,ij...,jy->xy...", Z,
                                A_h.reshape(A_h.shape + (1,) * (X.ndim - 2))
                                * X, Z)
        xbar = block_sums(W_h) / torch.clamp(n_act, min=1e-12)[..., None]
        S = (block_sums(W_h[..., :, None] * W_h[..., None, :])
             - n_act[..., None, None] * xbar[..., :, None]
             * xbar[..., None, :])
        mu, Sigma = sample_niw(g, niw_posterior(
            _niw_params(self), n_act.float(), xbar.float(), S.float()))
        return SBMState(c, pi, rho, mu, Sigma)


class LatentDistanceState(NamedTuple):
    """One chain's state, or C chains' with a leading chain axis on every
    field. L, gamma and hmc_accept live on the device, mu and Sigma on the
    host."""
    L: torch.Tensor           # (N, dim) latent positions
    gamma: torch.Tensor       # () connection-probability offset
    mu: torch.Tensor          # (B,) shared weight prior mean
    Sigma: torch.Tensor       # (B, B)
    hmc_accept: torch.Tensor  # () acceptance rate of the last sweep's HMC


class HMCNoise(NamedTuple):
    """The random numbers of one :meth:`LatentDistanceConfig.resample` on C
    chains, for callers that must reproduce a reference run. Trajectory k
    starts from the momenta (mom_L[:, k], mom_gamma[:, k]) and accepts if
    log u_hmc[:, k] < log alpha; swap move s proposes the pair
    swap_ij[:, s] and tests u_swap[:, s]; relocation r moves neuron
    reloc_i[:, r] to sigma_l * reloc_z[:, r] and tests u_reloc[:, r]."""
    mom_L: torch.Tensor       # (C, hmc_iters, N, dim)
    mom_gamma: torch.Tensor   # (C, hmc_iters)
    u_hmc: torch.Tensor       # (C, hmc_iters)
    swap_ij: torch.Tensor     # (C, swap_moves, 2) int64
    u_swap: torch.Tensor      # (C, swap_moves)
    reloc_i: torch.Tensor     # (C, relocate_moves) int64
    reloc_z: torch.Tensor     # (C, relocate_moves, dim)
    u_reloc: torch.Tensor     # (C, relocate_moves)


@dataclass(frozen=True)
class LatentDistanceConfig:
    """rho_ij = logistic(gamma - ||l_i - l_j||^2), l_i ~ N(0, sigma_l^2 I),
    gamma ~ N(0, sigma_gamma^2); (l, gamma) are resampled by leapfrog HMC
    with the closed-form gradient, then by optional discrete swap and
    relocation moves (exact MH on the rows and columns they touch), and the
    shared weight prior by its NIW posterior.

    Every array op runs over a leading chain axis, so one leapfrog step
    serves C chains (the lane-stacked ensemble, models/ensemble.py); a
    single chain's state has no chain axis.
    """
    N: int
    B: int
    dim: int = 2
    sigma_l: float = 1.0
    sigma_gamma: float = 2.0
    gamma_init: float = 0.0
    hmc_eps: float | None = None    # None -> 0.15 / sqrt(N)
    hmc_steps: int = 50
    hmc_iters: int = 10             # HMC trajectories per Gibbs sweep
    swap_moves: int = 0
    relocate_moves: int = 0
    mu_bias: object = -2.0          # scalar | (N,)
    sigma_bias: object = 1.0        # scalar | (N,)
    learn_weight_prior: bool = True
    niw_mu0: float = 0.0
    niw_kappa0: float = 1.0
    niw_nu0: float | None = None
    niw_psi0: float = 1.0
    mu_w: object = 0.0              # scalar | (B,) | (N,N,B); fixed prior only
    sigma_w: object = 1.0           # scalar | (B,) | (B,B) | (N,N,B,B) variance
    name: str = "latent_distance"

    def __post_init__(self):
        if self.learn_weight_prior and not (
                _is_scalar(self.sigma_w) and _is_scalar(self.mu_w)):
            raise ValueError(
                "per-edge mu_w/sigma_w require learn_weight_prior=False")

    @functools.cached_property
    def _fixed_hypers(self):
        return _fixed_weight_hypers(self)

    @property
    def eps(self) -> float:
        """Leapfrog step: the curvature of the potential grows ~N, so the
        default shrinks as 1/sqrt(N)."""
        return (self.hmc_eps if self.hmc_eps is not None
                else 0.15 / float(np.sqrt(self.N)))

    def init_state(self, gens, device="cpu") -> LatentDistanceState:
        """L ~ N(0, sigma_l^2 I) from the device generator ``gens.device``."""
        L = self.sigma_l * torch.randn((self.N, self.dim),
                                       generator=gens.device, device=device)
        return LatentDistanceState(
            L=L,
            gamma=torch.tensor(self.gamma_init, dtype=torch.float32,
                               device=device),
            mu=torch.zeros((self.B,), dtype=torch.float32),
            Sigma=torch.eye(self.B, dtype=torch.float32)
            * _sigma_w_scalar(self),
            hmc_accept=torch.zeros((), dtype=torch.float32, device=device))

    @staticmethod
    def _logit_rho(L, gamma):
        """gamma - ||l_i - l_j||^2, (..., N, N) from L (..., N, dim)."""
        d2 = torch.sum((L[..., :, None, :] - L[..., None, :, :]) ** 2,
                       dim=-1)
        return gamma[..., None, None] - d2

    def edge_hypers(self, state: LatentDistanceState, device) -> EdgeHypers:
        mu, Lam = _weight_hypers(self, state, device)
        lrho = torch.clamp(self._logit_rho(state.L, state.gamma),
                           -15.0, 15.0).to(device)
        mu_b, lam_b = _bias_hypers(self, self.N, device)
        return EdgeHypers(mu, Lam, lrho, mu_b, lam_b)

    def _potential(self, L, gamma, A):
        """U = -(log p(A | L, gamma) + log p(L) + log p(gamma)), (C,)."""
        lrho = self._logit_rho(L, gamma)
        ll = torch.sum(A * lrho - softplus(lrho), dim=(-2, -1))
        lp = (-0.5 * torch.sum(L ** 2, dim=(-2, -1)) / self.sigma_l ** 2
              - 0.5 * gamma ** 2 / self.sigma_gamma ** 2)
        return -(ll + lp)

    def _potential_grad(self, L, gamma, A):
        """Closed-form (dU/dL, dU/dgamma). With w = sigmoid(lrho) - A and
        ws = w + w^T:
          dU/dl_k = 2 [(ws @ L)_k - rowsum(ws)_k l_k] + l_k / sigma_l^2
          dU/dgamma = sum(w) + gamma / sigma_gamma^2."""
        w = torch.sigmoid(self._logit_rho(L, gamma)) - A
        ws = w + w.transpose(-2, -1)
        gL = (2.0 * (ws @ L - ws.sum(dim=-1, keepdim=True) * L)
              + L / self.sigma_l ** 2)
        gg = w.sum(dim=(-2, -1)) + gamma / self.sigma_gamma ** 2
        return gL, gg

    def draw_noise(self, generator, C: int, device) -> HMCNoise:
        """One resample's random numbers for C chains, from `generator`."""
        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=device)

        def index(*shape):
            return torch.randint(0, self.N, shape, generator=generator,
                                 device=device)
        k, s, r = self.hmc_iters, self.swap_moves, self.relocate_moves
        return HMCNoise(normal(C, k, self.N, self.dim), normal(C, k),
                        uniform(C, k), index(C, s, 2), uniform(C, s),
                        index(C, r), normal(C, r, self.dim), uniform(C, r))

    def _hmc(self, L, gamma, A, noise: HMCNoise):
        """hmc_iters trajectories of hmc_steps merged-kick leapfrog steps
        for C chains at once, each with its own MH test. The gradient at a
        trajectory's end is its last step's, and the potential and gradient
        at the next start are carried, so a trajectory costs hmc_steps
        gradients. Returns (L, gamma, acceptance rate (C,))."""
        eps = self.eps
        U = self._potential(L, gamma, A)
        gL, gg = self._potential_grad(L, gamma, A)
        accepts = []
        for k in range(self.hmc_iters):
            mL, mg = noise.mom_L[:, k], noise.mom_gamma[:, k]
            K0 = 0.5 * (torch.sum(mL ** 2, dim=(-2, -1)) + mg ** 2)
            mL = mL - 0.5 * eps * gL
            mg = mg - 0.5 * eps * gg
            Ln, gn, gLn, ggn = L, gamma, gL, gg
            for _ in range(self.hmc_steps):
                Ln = Ln + eps * mL
                gn = gn + eps * mg
                gLn, ggn = self._potential_grad(Ln, gn, A)
                mL = mL - eps * gLn
                mg = mg - eps * ggn
            # the last full kick overshot by half a step: undo it.
            mL = mL + 0.5 * eps * gLn
            mg = mg + 0.5 * eps * ggn
            Un = self._potential(Ln, gn, A)
            K1 = 0.5 * (torch.sum(mL ** 2, dim=(-2, -1)) + mg ** 2)
            acc = torch.log(noise.u_hmc[:, k]) < U + K0 - Un - K1
            a3 = acc[:, None, None]
            L, gL = torch.where(a3, Ln, L), torch.where(a3, gLn, gL)
            gamma, gg = torch.where(acc, gn, gamma), torch.where(acc, ggn, gg)
            U = torch.where(acc, Un, U)
            accepts.append(acc)
        # count / iters: exact, so the rate repeats across devices
        rate = (torch.stack(accepts, dim=1).sum(dim=1).to(torch.float32)
                / self.hmc_iters if accepts else torch.zeros_like(gamma))
        return L, gamma, rate

    @staticmethod
    def _row_ll(L, gamma, i_pos, i_idx, A):
        """Bernoulli log-likelihood of all directed edges touching neuron
        i_idx[c] when it sits at i_pos[c], per chain c: L (C, N, dim),
        gamma (C,), i_pos (C, dim), i_idx (C,), A (C, N, N). The (i, i)
        self term appears in both the out- and in-sums and is subtracted
        once."""
        ar = torch.arange(L.shape[0], device=L.device)
        lr = gamma[:, None] - torch.sum((i_pos[:, None, :] - L) ** 2, dim=-1)
        sp = softplus(lr)
        ll_out = torch.sum(A[ar, i_idx, :] * lr - sp, dim=-1)
        ll_in = torch.sum(A[ar, :, i_idx] * lr - sp, dim=-1)
        self_t = A[ar, i_idx, i_idx] * lr[ar, i_idx] - sp[ar, i_idx]
        return ll_out + ll_in - self_t

    def _swap_scan(self, L, gamma, A, ij, u):
        """Sequential Metropolis exchanges l_i <-> l_j (ij (C, S, 2)). The
        position prior is exchangeable, so the MH ratio is the Bernoulli
        log-likelihood change of the touched rows and columns; i == j is a
        no-op."""
        ar = torch.arange(L.shape[0], device=L.device)
        for s in range(ij.shape[1]):
            i, j = ij[:, s, 0], ij[:, s, 1]
            li, lj = L[ar, i], L[ar, j]
            ll_cur = (self._row_ll(L, gamma, li, i, A)
                      + self._row_ll(L, gamma, lj, j, A))
            Lp = L.clone()
            Lp[ar, i] = lj
            Lp[ar, j] = li
            ll_new = (self._row_ll(Lp, gamma, lj, i, A)
                      + self._row_ll(Lp, gamma, li, j, A))
            acc = (torch.log(u[:, s]) < ll_new - ll_cur) & (i != j)
            L = torch.where(acc[:, None, None], Lp, L)
        return L

    def _relocate_scan(self, L, gamma, A, idx, z, u):
        """Sequential independence-Metropolis moves l_i' = sigma_l z (the
        prior, so prior and proposal densities cancel), accepted on the
        restricted A-likelihood."""
        ar = torch.arange(L.shape[0], device=L.device)
        for r in range(idx.shape[1]):
            i, l_new = idx[:, r], self.sigma_l * z[:, r]
            ll_cur = self._row_ll(L, gamma, L[ar, i], i, A)
            Lp = L.clone()
            Lp[ar, i] = l_new
            ll_new = self._row_ll(Lp, gamma, l_new, i, A)
            acc = torch.log(u[:, r]) < ll_new - ll_cur
            L = torch.where(acc[:, None, None], Lp, L)
        return L

    def resample(self, gens, state: LatentDistanceState, A, W,
                 noise: HMCNoise | None = None) -> LatentDistanceState:
        """HMC on (L, gamma), then the swap and relocation moves, on the
        device (noise from ``gens.device`` unless `noise` is given); then
        (mu, Sigma) from the NIW posterior of the active weights, drawn on
        the host from ``gens.host``. `state`, A (N, N) and W (N, N, B) may
        carry a leading chain axis."""
        single = state.L.ndim == 2
        if single:
            state = LatentDistanceState(*(x[None] for x in state))
            A, W = A[None], W[None]
        C = A.shape[0]
        if noise is None:
            noise = self.draw_noise(gens.device, C, state.L.device)
        L, gamma, rate = self._hmc(state.L, state.gamma, A, noise)
        L = self._swap_scan(L, gamma, A, noise.swap_ij, noise.u_swap)
        L = self._relocate_scan(L, gamma, A, noise.reloc_i, noise.reloc_z,
                                noise.u_reloc)
        mu, Sigma = state.mu, state.Sigma
        if self.learn_weight_prior:
            n, xbar, S = _masked_stats(W, A)
            mu, Sigma = map(torch.stack, zip(*(
                _masked_niw_resample(gens.host, self, n[c], xbar[c], S[c])
                for c in range(C))))
        out = LatentDistanceState(L, gamma, mu, Sigma, rate)
        return LatentDistanceState(*(x[0] for x in out)) if single else out


# Each prior's accepted names (as the JAX package's make_network maps them).
_NETWORKS = {
    "dense": (DenseNetworkConfig, ("dense",)),
    "erdos_renyi": (ErdosRenyiConfig,
                    ("erdos_renyi", "er", "independent", "sparse")),
    "sbm": (SBMConfig, ("sbm", "stochastic_block")),
    "latent_distance": (LatentDistanceConfig,
                        ("latent_distance", "distance")),
}


def network_name(network) -> str:
    """The canonical name of a prior, given its config or any of its names:
    'dense', 'erdos_renyi', 'sbm' or 'latent_distance'."""
    name = getattr(network, "name", network).lower()
    for key, (_, names) in _NETWORKS.items():
        if name in names:
            return key
    raise ValueError(f"unknown network prior: {name}")


def make_network(name: str, N: int, B: int, **kwargs):
    return _NETWORKS[network_name(name)][0](N=N, B=B, **kwargs)
