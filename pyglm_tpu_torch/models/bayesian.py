"""Conjugate Bayesian building blocks (PyTorch counterpart of
``pyglm_tpu/models/bayesian.py``, after ``pybasicbayes``'s ``Gaussian``,
``Regression`` and ``DiagonalRegression``): the multivariate Gaussian with
a normal-inverse-Wishart prior, linear regression with a
matrix-normal-inverse-Wishart prior, and linear regression with diagonal
noise (Gaussian rows, inverse-gamma variances), each resampled by its
conjugate update on the draws of ``ops/linalg.py``.

Each object draws from its own generators (seeded from `seed`) on its
`device`, the card unless the caller asks for the CPU; data may be numpy
arrays or tensors, and the parameters (``mu``, ``sigma``, ``A``,
``sigmasq``) are numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pyglm_tpu_torch.models.abstractions import GibbsSampling
from pyglm_tpu_torch.models.ensemble import chain_generators
from pyglm_tpu_torch.ops.linalg import (
    NIWParams, niw_posterior, sample_invwishart, sample_inverse_gamma,
    sample_mvn_info, sample_niw,
)
from pyglm_tpu_torch.utils.utils import (
    as_f32, fp32_matmul, require_device,
)


class _Conjugate(GibbsSampling):
    """The device, the generators and tensor conversion the three share."""

    def _setup(self, seed: int, device) -> None:
        self.device = require_device(device)
        self.generators = chain_generators(seed, self.device)

    @property
    def _gen(self) -> torch.Generator:
        return self.generators.device

    def _t(self, x) -> torch.Tensor:
        return as_f32(x, self.device)

    def _rows(self, x) -> torch.Tensor:
        x = self._t(x)
        return x[None] if x.ndim == 1 else x


class Gaussian(_Conjugate):
    """Multivariate Gaussian with NIW-conjugate (mu, Sigma) Gibbs updates.
    Prior: Sigma ~ IW(nu_0, sigma_0), mu | Sigma ~ N(mu_0, Sigma /
    kappa_0); nu_0 defaults to D + 2."""

    def __init__(self, mu_0=None, sigma_0=None, kappa_0=1.0, nu_0=None,
                 D=None, seed: int = 0, device="cuda"):
        self._setup(seed, device)
        if mu_0 is None:
            if D is None:
                raise ValueError("give mu_0 or D")
            mu_0 = np.zeros(D)
        mu_0 = self._t(mu_0)
        D = mu_0.shape[0]
        sigma_0 = (torch.eye(D, device=self.device) if sigma_0 is None
                   else self._t(sigma_0))
        self.prior = NIWParams(
            mu0=mu_0, kappa0=self._t(float(kappa_0)),
            nu0=self._t(float(nu_0 if nu_0 is not None else D + 2)),
            Psi0=sigma_0)
        self._draw(self.prior)

    def _draw(self, p: NIWParams) -> None:
        mu, sigma = sample_niw(self._gen, p)
        self.mu, self.sigma = mu.cpu().numpy(), sigma.cpu().numpy()

    @fp32_matmul()
    def resample(self, data=None):
        """(mu, Sigma) from the posterior given data (n, D) (or the prior
        given none)."""
        if data is None or len(data) == 0:
            post = self.prior
        else:
            X = self._rows(data)
            xbar = X.mean(0)
            S = (X - xbar).T @ (X - xbar)
            post = niw_posterior(self.prior, X.shape[0], xbar, S)
        self._draw(post)
        return self

    @fp32_matmul()
    def log_likelihood(self, x):
        """Log density of each row of x (n, D) under N(mu, Sigma): numpy
        (n,)."""
        x = self._rows(x)
        C = torch.linalg.cholesky(self._t(self.sigma))
        z = torch.linalg.solve_triangular(C, (x - self._t(self.mu)).T,
                                          upper=False)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(C)))
        D = x.shape[-1]
        return (-0.5 * torch.sum(z * z, dim=0)
                - 0.5 * (logdet + D * math.log(2 * math.pi))).cpu().numpy()

    def rvs(self, size: int = 1):
        """(size, D) draws, numpy."""
        C = np.linalg.cholesky(self.sigma)
        eps = torch.randn((size, self.mu.shape[0]), generator=self._gen,
                          device=self.device).cpu().numpy()
        return self.mu + eps @ C.T


class _Linear(_Conjugate):
    """What the two regressions share: y = A [x; 1] + noise."""

    def _pad(self, X) -> torch.Tensor:
        X = self._rows(X)
        if self.affine:
            X = torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)
        return X

    @fp32_matmul()
    def _resid(self, data):
        X, Y = data
        return self._rows(Y) - self._pad(X) @ self._t(self.A).T


class DiagonalRegression(_Linear):
    """Linear regression with diagonal Gaussian noise: per output, a
    conjugate Gaussian row of A (prior N(mu_w, sigmasq_w)) and an
    inverse-gamma noise variance (prior IG(alpha_0, beta_0))."""

    def __init__(self, D_out: int, D_in: int, affine: bool = True,
                 mu_w=0.0, sigmasq_w=1.0, alpha_0: float = 2.0,
                 beta_0: float = 1.0, seed: int = 0, device="cuda"):
        self._setup(seed, device)
        self.D_out, self.D_in, self.affine = D_out, D_in, affine
        P = D_in + (1 if affine else 0)
        self.mu_w = np.full((D_out, P), mu_w, np.float32)
        self.lam_w = np.full((D_out, P), 1.0 / sigmasq_w, np.float32)
        self.alpha_0, self.beta_0 = float(alpha_0), float(beta_0)
        eps = torch.randn((D_out, P), generator=self._gen,
                          device=self.device).cpu().numpy()
        self.A = np.array(self.mu_w + eps / np.sqrt(self.lam_w))
        self.sigmasq = np.full(D_out, beta_0 / max(alpha_0 - 1, 0.5),
                               np.float32)

    @fp32_matmul()
    def resample(self, data):
        """Rows of A given the variances, then the variances given A, from
        data (X (T, D_in), Y (T, D_out))."""
        X, Y = data
        Xp, Y = self._pad(X), self._rows(Y)
        s2 = self._t(self.sigmasq)
        lam, mu = self._t(self.lam_w), self._t(self.mu_w)
        J = (Xp.T @ Xp)[None] / s2[:, None, None] + torch.diag_embed(lam)
        h = (Xp.T @ Y).T / s2[:, None] + lam * mu
        A = sample_mvn_info(self._gen, h, J)
        resid = Y - Xp @ A.T
        s2 = sample_inverse_gamma(
            self.alpha_0 + 0.5 * Xp.shape[0],
            self.beta_0 + 0.5 * torch.sum(resid ** 2, dim=0), self._gen)
        self.A = A.cpu().numpy()
        self.sigmasq = torch.clamp(s2, min=1e-8).cpu().numpy()
        return self

    def log_likelihood(self, data):
        """Log density of each row of data (X, Y): numpy (T,)."""
        resid = self._resid(data)
        s2 = self._t(self.sigmasq)
        return torch.sum(-0.5 * torch.log(2 * math.pi * s2)
                         - 0.5 * resid ** 2 / s2, dim=1).cpu().numpy()

    @fp32_matmul()
    def rvs(self, X):
        mean = self._pad(X) @ self._t(self.A).T
        eps = torch.randn(mean.shape, generator=self._gen, device=self.device)
        return (mean + eps * torch.sqrt(self._t(self.sigmasq))).cpu().numpy()


class Regression(_Linear):
    """Bayesian linear regression y = A [x; 1] + eps, eps ~ N(0, Sigma),
    with matrix-normal-inverse-Wishart conjugacy. Prior: Sigma ~ IW(nu_0,
    S_0), A | Sigma ~ MN(M_0, Sigma, K_0^{-1})."""

    def __init__(self, D_out: int, D_in: int, affine: bool = True,
                 M_0=None, K_0=None, nu_0=None, S_0=None, seed: int = 0,
                 device="cuda"):
        self._setup(seed, device)
        self.D_out, self.D_in, self.affine = D_out, D_in, affine
        P = D_in + (1 if affine else 0)
        self.M_0 = (np.zeros((D_out, P), np.float32) if M_0 is None
                    else np.asarray(M_0, np.float32))
        self.K_0 = (np.eye(P, dtype=np.float32) if K_0 is None
                    else np.asarray(K_0, np.float32))
        self.nu_0 = float(nu_0 if nu_0 is not None else D_out + 2)
        self.S_0 = (np.eye(D_out, dtype=np.float32) if S_0 is None
                    else np.asarray(S_0, np.float32))
        self.A = self.M_0.copy()
        self.sigma = self.S_0 / max(self.nu_0 - D_out - 1, 1.0)
        self.resample([])   # a prior draw

    @fp32_matmul()
    def resample(self, data=None):
        """(Sigma, A) from the MNIW posterior given data: an (X, Y) tuple
        or a list of them (none: the prior)."""
        if data is None:
            data = []
        if isinstance(data, tuple):
            data = [data]
        P = self.M_0.shape[1]
        M0, K0 = self._t(self.M_0), self._t(self.K_0)
        Sxx, Syx = K0, M0 @ K0
        Syy = self._t(self.S_0) + M0 @ K0 @ M0.T
        n = self.nu_0
        for X, Y in data:
            Xp, Yp = self._pad(X), self._rows(Y)
            Sxx = Sxx + Xp.T @ Xp
            Syx = Syx + Yp.T @ Xp
            Syy = Syy + Yp.T @ Yp
            n += Xp.shape[0]
        # M_n = Syx Sxx^{-1}; S_n = Syy - M_n Syx'
        eye_p = torch.eye(P, device=self.device)
        Sxx = 0.5 * (Sxx + Sxx.T) + 1e-6 * eye_p
        M_n = torch.linalg.solve(Sxx, Syx.T).T
        S_n = Syy - M_n @ Syx.T
        S_n = (0.5 * (S_n + S_n.T)
               + 1e-6 * torch.eye(self.D_out, device=self.device))
        sigma = sample_invwishart(self._gen, self._t(n), S_n)
        # A | Sigma ~ MN(M_n, Sigma, Sxx^{-1}):
        # A = M_n + chol(Sigma) E chol(Sxx)^{-T}, E iid N(0, 1)
        Cs = torch.linalg.cholesky(sigma)
        Cx = torch.linalg.cholesky(Sxx)
        E = torch.randn((self.D_out, P), generator=self._gen,
                        device=self.device)
        A = M_n + Cs @ torch.linalg.solve_triangular(Cx.T, E.T,
                                                     upper=True).T
        self.A, self.sigma = A.cpu().numpy(), sigma.cpu().numpy()
        return self

    def log_likelihood(self, data):
        """Log density of each row of data (X, Y): numpy (T,)."""
        resid = self._resid(data)
        C = torch.linalg.cholesky(self._t(self.sigma))
        z = torch.linalg.solve_triangular(C, resid.T, upper=False)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(C)))
        return (-0.5 * torch.sum(z * z, dim=0) - 0.5 * (
            logdet + self.D_out * math.log(2 * math.pi))).cpu().numpy()

    @fp32_matmul()
    def rvs(self, X):
        mean = self._pad(X) @ self._t(self.A).T
        C = torch.linalg.cholesky(self._t(self.sigma))
        eps = torch.randn(mean.shape, generator=self._gen, device=self.device)
        return (mean + eps @ C.T).cpu().numpy()
