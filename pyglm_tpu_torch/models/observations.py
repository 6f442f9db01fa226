"""Observation families (PyTorch counterpart of
``pyglm_tpu/models/observations.py``: ``Bernoulli``, ``Binomial``,
``NegativeBinomial`` and ``Gaussian``).

A family maps data to the conditionally-Gaussian form
likelihood(psi) prop-to exp(kappa psi - omega psi^2 / 2): PG-augmented
(omega ~ PG(b, psi)) for the logistic links, deterministic (omega =
1/eta) for the Gaussian; plus per-neuron auxiliary-parameter updates (the
NB dispersion r by the Chinese-restaurant-table augmentation, the Gaussian
noise variance eta by inverse-gamma conjugacy).

Parallel tempering (models/tempering.py) asks each family for the
auxiliaries of its beta-power likelihood L(psi)^beta, beta a per-lane
(lanes,) vector: ``tempered_omega_kappa``. The power stays PG-conjugate
with the shape scaled, b -> beta b, and kappa -> beta kappa (the
Gaussian's precision scales by beta). ``tempering_blocker`` says why a
family cannot temper with its current flags (a resampled likelihood
auxiliary), or None.

Generation (models/sweep.py) draws the psi-independent noise of all T bins
at once with ``sample_noise`` and then each bin with
``sample(generator, psi_t, aux, noise_t)``; ``sample`` without noise draws
it itself.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pyglm_tpu_torch.ops.linalg import (
    crt_sample, sample_gamma, sample_inverse_gamma,
)
from pyglm_tpu_torch.ops.polyagamma import pg_draw_unit, polya_gamma
from pyglm_tpu_torch.utils.utils import logistic, softplus


class _FamilyBase:
    """Hooks shared by every family. ``ll_cache`` summarises the
    psi-independent part of a dataset's likelihood once at ``add_data`` so
    the per-sweep total (``log_likelihood_sum``) skips it; None means the
    family has no such structure."""
    needs_pg: bool = True

    def init_aux(self, N: int, device="cpu"):
        return None

    def ll_cache(self, Y):
        return None

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        return torch.sum(self.log_likelihood(Y, psi, aux))

    def sample_noise(self, generator, shape, aux):
        return None

    def resample_aux(self, generator, aux, Y, psi, cache=None):
        return aux

    def tempering_blocker(self):
        """None if the family tempers exactly with its current flags, else
        the reason: a resampled likelihood auxiliary (NB r, Gaussian eta),
        whose conjugate update assumes the untempered likelihood."""
        return None


@dataclass(frozen=True)
class Bernoulli(_FamilyBase):
    """y ~ Bern(logistic(psi)); kappa = y - 1/2, b_pg = 1 (exact Devroye)."""
    name: str = "bernoulli"

    def omega_kappa(self, generator: torch.Generator, Y, psi, aux):
        """omega ~ PG(1, psi) (kernel K1 on the card), kappa = y - 1/2."""
        return pg_draw_unit(psi, generator), Y - 0.5

    def tempered_omega_kappa(self, generator, Y, psi, aux, beta):
        """omega ~ PG(beta, psi) by the gamma series (kernel K4 on the
        card: the shape is fractional), kappa = beta (y - 1/2)."""
        b = torch.broadcast_to(beta[None, :], psi.shape)
        omega = polya_gamma(b, psi, generator, method="real")
        return omega, beta[None, :] * (Y - 0.5)

    def log_likelihood(self, Y, psi, aux):
        return Y * psi - softplus(psi)

    def sample_noise(self, generator, shape, aux):
        """Uniforms U, so that y = 1[U < logistic(psi)]."""
        return torch.rand(shape, generator=generator,
                          device=generator.device)

    def sample(self, generator, psi, aux, noise=None):
        """y = 1[U < logistic(psi)] as float32; U = `noise` if given."""
        if noise is None:
            noise = self.sample_noise(generator, psi.shape, aux)
        return (noise < logistic(psi)).to(torch.float32)

    def mean(self, psi, aux):
        return logistic(psi)


def _lgamma_const(Y, n: float):
    """log C(n, y) = lgamma(n+1) - lgamma(y+1) - lgamma(n-y+1)."""
    n1 = torch.tensor(n + 1.0, dtype=torch.float32)
    return (torch.lgamma(n1).item() - torch.lgamma(Y + 1.0)
            - torch.lgamma(n - Y + 1.0))


@dataclass(frozen=True)
class Binomial(_FamilyBase):
    """y ~ Binom(n_trials, logistic(psi)); kappa = y - n/2, b_pg = n."""
    n_trials: int = 1
    name: str = "binomial"

    def omega_kappa(self, generator, Y, psi, aux):
        """omega ~ PG(n, psi) by the hybrid sampler: K1 when n == 1, else
        K4 (the normal approximation from n >= 170)."""
        b = torch.full_like(psi, float(self.n_trials))
        return (polya_gamma(b, psi, generator),
                Y - 0.5 * self.n_trials)

    def tempered_omega_kappa(self, generator, Y, psi, aux, beta):
        """omega ~ PG(n beta, psi) by the gamma series (K4 on the card),
        kappa = beta (y - n/2)."""
        b = torch.broadcast_to(float(self.n_trials) * beta[None, :],
                               psi.shape)
        omega = polya_gamma(b, psi, generator, method="real")
        return omega, beta[None, :] * (Y - 0.5 * self.n_trials)

    def log_likelihood(self, Y, psi, aux):
        n = float(self.n_trials)
        return _lgamma_const(Y, n) + Y * psi - n * softplus(psi)

    def ll_cache(self, Y):
        """The dataset's total log C(n, y): a scalar, state-independent."""
        return {"logC_sum": torch.sum(_lgamma_const(Y, float(self.n_trials)))}

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        if cache is None:
            return torch.sum(self.log_likelihood(Y, psi, aux))
        n = float(self.n_trials)
        return cache["logC_sum"] + torch.sum(Y * psi - n * softplus(psi))

    def sample(self, generator, psi, aux, noise=None):
        count = torch.full_like(psi, float(self.n_trials))
        return torch.binomial(count, logistic(psi), generator=generator)

    def mean(self, psi, aux):
        return self.n_trials * logistic(psi)


@dataclass(frozen=True)
class NegativeBinomial(_FamilyBase):
    """y ~ NB(r, p = logistic(psi)): mean r e^psi; kappa = (y - r)/2,
    b_pg = y + r. The per-neuron dispersion r is resampled by the
    Zhou-Carin CRT + Gamma augmentation. `max_y` must bound the counts."""
    r_init: float = 4.0
    a_r: float = 2.0          # Gamma(a_r, b_r) prior on r
    b_r: float = 0.5
    max_y: int = 256
    resample_r: bool = True
    name: str = "negative_binomial"

    def init_aux(self, N: int, device="cpu"):
        return {"r": torch.full((N,), self.r_init, dtype=torch.float32,
                                device=device)}

    def omega_kappa(self, generator, Y, psi, aux):
        """omega ~ PG(y + r, psi) by the gamma series (kernel K4 on the
        card; b is generically non-integer, so no Devroye regime),
        kappa = (y - r) / 2."""
        r = aux["r"][None, :]
        omega = polya_gamma(Y + r, psi, generator, method="real")
        return omega, 0.5 * (Y - r)

    def tempering_blocker(self):
        if self.resample_r:
            return ("NegativeBinomial with resample_r=True: the CRT r "
                    "update assumes the untempered likelihood; construct "
                    "with resample_r=False (fixed dispersion) to temper")
        return None

    def tempered_omega_kappa(self, generator, Y, psi, aux, beta):
        """omega ~ PG(beta (y + r), psi) at fixed r (K4 on the card),
        kappa = beta (y - r) / 2."""
        r = aux["r"][None, :]
        omega = polya_gamma(beta[None, :] * (Y + r), psi, generator,
                            method="real")
        return omega, beta[None, :] * 0.5 * (Y - r)

    def log_likelihood(self, Y, psi, aux):
        r = aux["r"][None, :]
        logC = torch.lgamma(Y + r) - torch.lgamma(r) - torch.lgamma(Y + 1.0)
        return logC + Y * psi - (Y + r) * softplus(psi)

    def ll_cache(self, Y):
        """{'counts': (max_y+1, N) float32}, counts[k, n] = #{t: y_tn = k},
        by one bincount over y + K * column on Y's device. Raises
        ValueError if a count exceeds max_y (it would vanish from the
        table and bias both the normaliser and the r update)."""
        K = self.max_y + 1
        Yi = Y.to(torch.int64)
        y_max = int(Yi.max()) if Yi.numel() else 0
        if y_max > self.max_y:
            raise ValueError(f"observed count {y_max} exceeds max_y="
                             f"{self.max_y}; construct the family with a "
                             f"larger max_y")
        N = Y.shape[1]
        col = torch.arange(N, device=Y.device)[None, :]
        counts = torch.bincount((Yi + K * col).reshape(-1), minlength=K * N)
        return {"counts": counts.reshape(N, K).T.to(torch.float32)}

    def log_likelihood_sum(self, Y, psi, aux, cache=None):
        if cache is None:
            return torch.sum(self.log_likelihood(Y, psi, aux))
        r = aux["r"]
        counts = cache["counts"]
        k = torch.arange(counts.shape[0], dtype=torch.float32,
                         device=counts.device)[:, None]
        logC = (torch.lgamma(k + r[None, :]) - torch.lgamma(r)[None, :]
                - torch.lgamma(k + 1.0))
        return (torch.sum(counts * logC)
                + torch.sum(Y * psi - (Y + r[None, :]) * softplus(psi)))

    def sample_noise(self, generator, shape, aux):
        """The Gamma(r) factors of the Gamma-Poisson mixture; they do not
        depend on psi, so generation draws all bins' at once."""
        r = torch.broadcast_to(aux["r"], shape)
        return sample_gamma(r, generator)

    def sample(self, generator, psi, aux, noise=None):
        """y ~ Poisson(min(G e^psi, 1e6)), G ~ Gamma(r) (= `noise` if
        given). The cap keeps runaway autoregressive dynamics finite."""
        if noise is None:
            noise = self.sample_noise(generator, psi.shape, aux)
        lam = torch.clamp(noise * torch.exp(psi), max=1e6)
        return torch.poisson(lam, generator=generator)

    def mean(self, psi, aux):
        return aux["r"][None, :] * torch.exp(psi)

    def resample_aux(self, generator, aux, Y, psi, cache=None):
        """r ~ Gamma(a_r + sum_t l_tn) / (b_r + sum_t softplus psi_tn),
        floored at 1e-3, with l the CRT table counts given y and r.

        With the count table (`cache`), sum_t l_tn is drawn collapsed:
        the Bernoulli(r/(r+i)) of all elements with y > i share one
        Binomial(#{t: y_tn > i}, r/(r+i)), an exact regrouping; i = 0 has
        p = 1. Without it, kernel K5 (``crt_sample``) draws l per element.
        The (N,) and (max_y+1, N) work runs on the host on `generator`
        after one transfer, so the update adds one host sync to a sweep;
        r goes back to the device from pinned memory without another."""
        if not self.resample_r:
            return aux
        r = aux["r"]
        rate = self.b_r + torch.sum(softplus(psi), dim=0)
        if cache is None:
            l = crt_sample(Y, r, self.max_y, generator)
            lsum, rate = torch.stack(
                [torch.sum(l, dim=0).to(torch.float32), rate]).cpu()
        else:
            host = torch.cat([cache["counts"], rate[None], r[None]]).cpu()
            counts, rate, r_h = host[:-2], host[-2], host[-1]
            # m[i] = #{t : y_tn > i} for i = 0 .. max_y - 1
            m = torch.flip(torch.cumsum(torch.flip(counts, [0]), 0), [0])[1:]
            i = torch.arange(1, counts.shape[0] - 1,
                             dtype=torch.float32)[:, None]
            p = r_h[None, :] / (r_h[None, :] + i)
            draws = torch.binomial(m[1:], p.expand_as(m[1:]).contiguous(),
                                   generator=generator)
            lsum = m[0] + torch.sum(draws, dim=0)
        r_new = torch.clamp(sample_gamma(self.a_r + lsum, generator) / rate,
                            min=1e-3)
        if r.is_cuda:       # copy back without a second wait on the device
            r_new = r_new.pin_memory()
        return {"r": r_new.to(r.device, non_blocking=True)}


@dataclass(frozen=True)
class Gaussian(_FamilyBase):
    """y ~ N(psi, eta_n): identity link, conjugate noise variance. No PG
    augmentation: omega = 1/eta_n and kappa = y/eta_n are deterministic,
    which gives the exact Gaussian conditional of the weights; eta is
    resampled by inverse-gamma conjugacy. Since omega is constant over
    time, the models cache the unweighted Gram statistics at add_data and
    divide them by eta each sweep (models/sweep.py)."""
    eta_init: float = 1.0
    a_eta: float = 2.0        # InvGamma(a_eta, b_eta) prior on eta
    b_eta: float = 1.0
    resample_eta: bool = True
    name: str = "gaussian"
    needs_pg: bool = False

    def init_aux(self, N: int, device="cpu"):
        return {"eta": torch.full((N,), self.eta_init, dtype=torch.float32,
                                  device=device)}

    def omega_kappa(self, generator, Y, psi, aux):
        """omega = 1/eta (materialised (T, N): the kernels read it as a
        dense array), kappa = y/eta; draws nothing."""
        inv_eta = 1.0 / aux["eta"][None, :]
        return inv_eta.expand_as(Y).contiguous(), Y * inv_eta

    def tempering_blocker(self):
        if self.resample_eta:
            return ("Gaussian with resample_eta=True: the inverse-gamma "
                    "eta update assumes the untempered likelihood; "
                    "construct with resample_eta=False to temper")
        return None

    def tempered_omega_kappa(self, generator, Y, psi, aux, beta):
        """N(y | psi, eta)^beta is Gaussian with precision beta / eta:
        omega and kappa scale by beta; draws nothing."""
        om, ka = self.omega_kappa(generator, Y, psi, aux)
        return beta[None, :] * om, beta[None, :] * ka

    def log_likelihood(self, Y, psi, aux):
        eta = aux["eta"][None, :]
        return (-0.5 * torch.log(2.0 * math.pi * eta)
                - 0.5 * (Y - psi) ** 2 / eta)

    def sample_noise(self, generator, shape, aux):
        """Standard normals; they do not depend on psi, so generation draws
        all bins' at once."""
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    def sample(self, generator, psi, aux, noise=None):
        """y = psi + sqrt(eta) z, z ~ N(0, 1) (= `noise` if given)."""
        if noise is None:
            noise = self.sample_noise(generator, psi.shape, aux)
        return psi + torch.sqrt(aux["eta"]) * noise

    def mean(self, psi, aux):
        return psi

    def resample_aux(self, generator, aux, Y, psi, cache=None):
        """eta ~ InvGamma(a_eta + T/2, b_eta + sum_t (y - psi)^2 / 2),
        floored at 1e-6. The (N,) draw runs on the host on `generator` after
        one transfer; eta goes back to the device from pinned memory."""
        if not self.resample_eta:
            return aux
        eta = aux["eta"]
        beta = (self.b_eta + 0.5 * torch.sum((Y - psi) ** 2, dim=0)).cpu()
        eta_new = torch.clamp(sample_inverse_gamma(
            self.a_eta + 0.5 * Y.shape[0], beta, generator), min=1e-6)
        if eta.is_cuda:
            eta_new = eta_new.pin_memory()
        return {"eta": eta_new.to(eta.device, non_blocking=True)}


def make_observation(name: str, **kwargs):
    name = name.lower()
    if name == "bernoulli":
        return Bernoulli(**kwargs)
    if name == "binomial":
        return Binomial(**kwargs)
    if name in ("negative_binomial", "nb", "negbin"):
        return NegativeBinomial(**kwargs)
    if name == "gaussian":
        return Gaussian(**kwargs)
    raise ValueError(f"unknown observation family: {name}")
