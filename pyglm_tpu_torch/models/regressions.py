"""Standalone PG-augmented logistic regressions (PyTorch counterpart of
``pyglm_tpu/models/regressions.py``, after ``pypolyagamma``'s
``BernoulliRegression``, ``BinomialRegression``,
``NegativeBinomialRegression`` and ``MultinomialRegression``): Bayesian
GLMs y ~ f(psi), psi = A x + b, on arbitrary covariates, with Gaussian
priors on the rows of [A | b] and exact Gibbs through Polya-gamma
auxiliaries. The multinomial uses the stick-breaking construction
(ops/stick_breaking.py).

A resample draws omega ~ PG(b(y), psi) (kernel K1 where every b is 1,
else K4 on the card; the multinomial's sticks mix both), forms every
output's precision J_d = Xb' diag(omega_d) Xb + diag(lambda_d) by the
dense update's chunked fp32 GEMMs (models/weights.py::sufficient_stats:
no (T, D_out, P) tensor is formed), and draws all D_out rows by one batched
Cholesky (ops/linalg.py::sample_mvn_info). The NB dispersion r is
resampled through the CRT counts (kernel K5 on the card).

Data (X, y) may be numpy arrays or tensors; it goes to the model's
`device` (the card unless the caller asks for the CPU). ``.A`` (D_out,
D_in) and ``.b`` (D_out,) are mutable numpy arrays, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.ensemble import chain_generators
from pyglm_tpu_torch.models.weights import sufficient_stats
from pyglm_tpu_torch.ops.linalg import (
    crt_sample, sample_gamma, sample_mvn_info,
)
from pyglm_tpu_torch.ops.polyagamma import polya_gamma
from pyglm_tpu_torch.ops.stick_breaking import N_vec, kappa_vec, psi_to_pi
from pyglm_tpu_torch.utils.utils import (
    as_f32, fp32_matmul, logistic, require_device, softplus,
)


def posterior_info(X, kappa, omega, mu_prior, lam_prior):
    """The rows' Gaussian posteriors in information form: J (D_out, P, P)
    = Xb' diag(omega_d) Xb + diag(lam_d) and h (D_out, P) = Xb' kappa_d +
    lam_d mu_d, Xb = [X | 1]. X (T, D_in); kappa, omega (T, D_out); prior
    means and precisions (D_out, P). J's products are the dense update's
    chunked fp32 GEMMs."""
    Xb = torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)
    J, h = sufficient_stats(Xb, omega, kappa)
    return J + torch.diag_embed(lam_prior), h.T + lam_prior * mu_prior


def resample_weights(generator, X, kappa, omega, mu_prior, lam_prior,
                     eps=None):
    """One conjugate draw of every output's row of [A | b] (D_out, P):
    N(J^{-1} h, J^{-1}) from :func:`posterior_info`, one batched Cholesky;
    `eps` (D_out, P) the standard normals, or None to draw them from
    `generator` on X's device."""
    J, h = posterior_info(X, kappa, omega, mu_prior, lam_prior)
    return sample_mvn_info(generator, h, J, eps=eps)


class _PGLogisticRegressionBase:
    """psi = A x + b; subclasses define pg_b, kappa, _ll and rvs.

    Args:
      D_out, D_in: output and input dimensions.
      mu_A, sigmasq_A, mu_b, sigmasq_b: prior mean and variance of the
        weights and of the bias.
      seed: seed of the model's generators (the initial draw on the host
        generator, the rest as the network GLM draws).
      device: the card by default; device='cpu' runs the plain versions.
    """

    def __init__(self, D_out: int, D_in: int, mu_A=0.0, sigmasq_A=1.0,
                 mu_b=0.0, sigmasq_b=1.0, seed: int = 0, device="cuda"):
        self.D_out, self.D_in = D_out, D_in
        self.device = require_device(device)
        P = D_in + 1
        self._mu = np.full((D_out, P), mu_A, np.float32)
        self._mu[:, -1] = mu_b
        self._lam = np.full((D_out, P), 1.0 / sigmasq_A, np.float32)
        self._lam[:, -1] = 1.0 / sigmasq_b
        self.generators = chain_generators(seed, self.device)
        w = self._mu + torch.randn(
            (D_out, P), generator=self.generators.host).numpy() / np.sqrt(
                self._lam)
        self.A = np.array(w[:, :-1])
        self.b = np.array(w[:, -1])

    def _t(self, x):
        return as_f32(x, self.device)

    @fp32_matmul()
    def psi(self, X):
        """(T, D_out) activations of covariates X (T, D_in), a tensor on
        the model's device."""
        return self._t(X) @ self._t(self.A).T + self._t(self.b)

    # -- subclass hooks ------------------------------------------------
    def pg_b(self, y):
        raise NotImplementedError

    def kappa(self, y):
        raise NotImplementedError

    def _ll(self, y, psi):
        raise NotImplementedError

    def rvs(self, X):
        raise NotImplementedError

    def resample(self, datas):
        """One Gibbs sweep of (A, b) (and the subclass's aux) given
        [(X, y), ...] or one (X, y)."""
        if not isinstance(datas, list):
            datas = [datas]
        X = torch.cat([self._t(d[0]) for d in datas])
        y = torch.cat([self._t(d[1]) for d in datas])
        omega = polya_gamma(self.pg_b(y), self.psi(X), self.generators.host)
        w = resample_weights(self.generators.device, X, self.kappa(y), omega,
                             self._t(self._mu), self._t(self._lam))
        w = w.cpu().numpy()
        self.A, self.b = w[:, :-1].copy(), w[:, -1].copy()
        self._resample_aux(y, self.psi(X))

    def _resample_aux(self, y, psi):
        pass

    def log_likelihood(self, data):
        """Per-row log-likelihood of (X, y), summed over the outputs:
        numpy (T,)."""
        X, y = data
        return self._ll(self._t(y), self.psi(X)).cpu().numpy()


class BernoulliRegression(_PGLogisticRegressionBase):
    """y ~ Bern(logistic(psi)); PG(1, psi) by kernel K1 on the card."""

    def pg_b(self, y):
        return torch.ones_like(y)

    def kappa(self, y):
        return y - 0.5

    def _ll(self, y, psi):
        return torch.sum(y * psi - softplus(psi), dim=-1)

    def rvs(self, X):
        p = logistic(self.psi(X))
        u = torch.rand(p.shape, generator=self.generators.device,
                       device=p.device)
        return (u < p).to(torch.float32).cpu().numpy()


class BinomialRegression(_PGLogisticRegressionBase):
    """y ~ Binom(N, logistic(psi)); PG(N, psi) by kernel K4 on the card."""

    def __init__(self, N: int, D_out, D_in, **kw):
        self.N = N
        super().__init__(D_out, D_in, **kw)

    def pg_b(self, y):
        return torch.full_like(y, float(self.N))

    def kappa(self, y):
        return y - 0.5 * self.N

    def _ll(self, y, psi):
        n = float(self.N)
        logC = (torch.lgamma(torch.tensor(n + 1.0)).item()
                - torch.lgamma(y + 1.0) - torch.lgamma(n - y + 1.0))
        return torch.sum(logC + y * psi - n * softplus(psi), dim=-1)

    def rvs(self, X):
        p = logistic(self.psi(X))
        return torch.binomial(torch.full_like(p, float(self.N)), p,
                              generator=self.generators.device).cpu().numpy()


class NegativeBinomialRegression(_PGLogisticRegressionBase):
    """y ~ NB(r, logistic(psi)); PG(y + r, psi) by kernel K4 on the card;
    with ``resample_r`` the per-output dispersion r ~ Gamma(a_r + sum_t
    l_t) / (b_r + sum_t softplus(psi_t)), l the CRT counts (kernel K5 on
    the card), floored at 1e-3. `max_y` bounds the counts (ValueError
    above it: the CRT draw would drop them)."""

    def __init__(self, D_out, D_in, r=4.0, a_r=2.0, b_r=0.5, max_y=256,
                 resample_r=True, **kw):
        self.r = np.full(D_out, float(r), np.float32)
        self.a_r, self.b_r, self.max_y = a_r, b_r, int(max_y)
        self._do_r = resample_r
        super().__init__(D_out, D_in, **kw)

    def pg_b(self, y):
        return y + self._t(self.r)

    def kappa(self, y):
        return 0.5 * (y - self._t(self.r))

    def _ll(self, y, psi):
        r = self._t(self.r)
        logC = torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
        return torch.sum(logC + y * psi - (y + r) * softplus(psi), dim=-1)

    def _resample_aux(self, y, psi):
        if not self._do_r:
            return
        y_max = float(y.max())
        if y_max > self.max_y:
            raise ValueError(f"count {y_max:.0f} exceeds max_y={self.max_y}; "
                             f"construct with a larger max_y")
        host = self.generators.host
        l = crt_sample(y, self._t(self.r), self.max_y, host)
        lsum, rate = torch.stack([torch.sum(l, dim=0).to(torch.float32),
                                  self.b_r + torch.sum(softplus(psi),
                                                       dim=0)]).cpu()
        self.r = torch.clamp(sample_gamma(self.a_r + lsum, host) / rate,
                             min=1e-3).numpy()

    def rvs(self, X):
        psi = self.psi(X)
        g = self.generators.device
        lam = sample_gamma(torch.broadcast_to(self._t(self.r), psi.shape),
                           g) * torch.exp(psi)
        return torch.poisson(torch.clamp(lam, max=1e6),
                             generator=g).cpu().numpy()


class MultinomialRegression(_PGLogisticRegressionBase):
    """K-way counts y (T, K) by stick-breaking PG augmentation: K-1 stick
    outputs, PG(N_k, psi_k) (K1 where N_k = 1, K4 elsewhere on the
    card)."""

    def __init__(self, K: int, D_in, **kw):
        self.K = K
        super().__init__(K - 1, D_in, **kw)

    def pg_b(self, y):
        return N_vec(y)

    def kappa(self, y):
        return kappa_vec(y)

    def pi(self, X):
        """(T, K) category probabilities of X, numpy."""
        return psi_to_pi(self.psi(X)).cpu().numpy()

    def _ll(self, y, psi):
        pi = psi_to_pi(psi)
        total = torch.sum(y, dim=-1)
        logC = torch.lgamma(total + 1.0) - torch.sum(torch.lgamma(y + 1.0),
                                                     dim=-1)
        return logC + torch.sum(y * torch.log(torch.clamp(pi, min=1e-12)),
                                dim=-1)

    def rvs(self, X, n_trials: int = 1):
        """(T, K) counts of `n_trials` categorical draws a row."""
        pi = psi_to_pi(self.psi(X))
        draws = torch.multinomial(pi, n_trials, replacement=True,
                                  generator=self.generators.device)
        counts = torch.zeros_like(pi).scatter_add_(
            1, draws, torch.ones_like(draws, dtype=pi.dtype))
        return counts.cpu().numpy()
