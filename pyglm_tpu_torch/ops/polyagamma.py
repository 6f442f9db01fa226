"""Polya-Gamma PG(1, c) draws (PyTorch counterpart of the main-path subset
of ``pyglm_tpu/ops/polyagamma.py``).

- :func:`pg_mean`, :func:`pg_var`: closed-form moments, stable at c -> 0.
- :func:`pg_devroye_plain`: exact PG(1, c) by Devroye's alternating-series
  rejection sampler (Polson-Scott-Windle 2013, Alg. 1), the plain PyTorch
  version of kernel ``csrc/pg_devroye.cu``. It follows the JAX package's
  XLA sampler: log-space mixture weight q via ``logaddexp``, truncated
  inverse-Gaussian proposals below t = 0.64, exponential above, and an
  alternating-series test with ``_N_SERIES`` terms. Where JAX masks the whole
  batch every round, this version redraws only the pending elements.
- :func:`pg_draw_unit`: a CUDA tensor goes to the kernel, a CPU tensor to
  the plain version.

PG(1, c) = J*(1, c/2) / 4.
"""
from __future__ import annotations

import math

import torch

_PI = math.pi
_TRUNC = 0.64          # Devroye proposal truncation point t
_MAX_OUTER = 64        # proposal rounds (acceptance >= 0.9992 per round)
_MAX_INNER = 64        # truncated-inverse-Gaussian rounds
_N_SERIES = 4          # alternating-series terms: a_3/a_0 < 1e-17


def pg_mean(b, c):
    """E[PG(b, c)] = b/(2c) tanh(c/2), stable at c = 0 (-> b/4)."""
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32)
    x = 0.5 * torch.abs(c)
    small = x < 1e-3
    ratio = torch.where(
        small,
        1.0 - x * x / 3.0 + 2.0 * x ** 4 / 15.0,
        torch.tanh(x) / torch.where(small, torch.ones_like(x), x),
    )
    return 0.25 * b * ratio


def pg_var(b, c):
    """Var[PG(b, c)], stable at c = 0 (-> b/24)."""
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.abs(torch.as_tensor(c, dtype=torch.float32))
    t = torch.tanh(0.5 * c)
    # The exact form cancels for small c: switch to the Taylor series.
    small = c < 0.6
    num = 2.0 * t - c * (1.0 - t * t)
    exact = num / torch.where(small, torch.ones_like(c), 4.0 * c ** 3)
    c2 = c * c
    series = 1.0 / 24.0 - c2 / 120.0 + 17.0 * c2 * c2 / 13440.0
    return b * torch.where(small, series, exact)


def _log_coef(x, n: int):
    """log a_n(x) of the alternating series for J*(1, .), both branches:
    left (x <= t): pi(n+1/2) (2/(pi x))^{3/2} exp(-2(n+1/2)^2/x);
    right (x > t): pi(n+1/2) exp(-(n+1/2)^2 pi^2 x / 2)."""
    half = n + 0.5
    xs = torch.clamp(x, min=1e-30)
    logl = (math.log(_PI * half)
            + 1.5 * (math.log(2.0 / _PI) - torch.log(xs))
            - 2.0 * half * half / xs)
    logr = math.log(_PI * half) - half * half * _PI * _PI * xs / 2.0
    return torch.where(x <= _TRUNC, logl, logr)


def _exponential(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log1p(-u)                 # u in [0, 1): 1 - u in (0, 1]


def _trunc_inv_gauss(z, generator):
    """X ~ InverseGaussian(mu = 1/z, lambda = 1) restricted to (0, t).

    z t < 1: tilted Levy rejection (E1^2 <= 2 E2 / t, X = t/(1 + t E1)^2,
    accept w.p. exp(-z^2 X / 2)); z t >= 1: Michael-Schucany-Haas draws
    retried until X <= t. Returns (X, accepted); elements still pending
    after ``_MAX_INNER`` rounds report accepted = False.
    """
    t = _TRUNC
    dev = z.device
    X = torch.full_like(z, 0.5 * t)
    done = torch.zeros(z.shape, dtype=torch.bool, device=dev)
    idx = torch.arange(z.numel(), device=dev)
    for _ in range(_MAX_INNER):
        if idx.numel() == 0:
            break
        zi = z[idx]
        n = idx.shape
        E1 = _exponential(n, generator, dev)
        E2 = _exponential(n, generator, dev)
        XA = t / (1.0 + t * E1) ** 2
        accA = (E1 * E1 <= 2.0 * E2 / t) & (
            torch.rand(n, generator=generator, device=dev)
            <= torch.exp(-0.5 * zi * zi * XA))
        mu = 1.0 / torch.clamp(zi, min=1e-30)
        Yn = torch.randn(n, generator=generator, device=dev) ** 2
        muY = mu * Yn
        XB0 = mu + 0.5 * mu * muY - 0.5 * mu * torch.sqrt(4.0 * muY
                                                          + muY * muY)
        XB0 = torch.clamp(XB0, min=1e-30)
        takeB = (torch.rand(n, generator=generator, device=dev)
                 <= mu / (mu + XB0))
        XB = torch.where(takeB, XB0, mu * mu / XB0)
        useA = zi * t < 1.0
        Xn = torch.where(useA, XA, XB)
        acc = torch.where(useA, accA, XB <= t)
        X[idx[acc]] = Xn[acc]
        done[idx[acc]] = True
        idx = idx[~acc]
    return X, done


def _series_accept(X, generator):
    """Alternating-series test for proposals X: with Y = U a_0(X), accept
    iff Y <= the lower bound after ``_N_SERIES`` terms; the undecided band
    has mass of order a_N(X)."""
    la0 = _log_coef(X, 0)
    U = torch.rand(X.shape, generator=generator, device=X.device)
    Y = torch.exp(torch.log(torch.clamp(U, min=1e-12)) + la0)
    S = torch.exp(la0)
    lower = torch.zeros_like(S)
    for n in range(1, _N_SERIES + 1):
        term = torch.exp(_log_coef(X, n))
        if n % 2 == 1:
            S = S - term
            lower = S
        else:
            S = S + term
    return Y <= lower


def pg_devroye_plain(c: torch.Tensor, generator: torch.Generator):
    """Exact PG(1, c) draws, elementwise over any-shaped float32 `c`.

    Each round draws a proposal from Devroye's mixture for every pending
    element (exponential tail with probability p/(p+q), truncated inverse
    Gaussian otherwise) and keeps those the series test accepts. Elements
    still pending after ``_MAX_OUTER`` rounds (probability < 1e-190) keep
    the conditional mean tanh(z)/z.
    """
    c = torch.as_tensor(c, dtype=torch.float32)
    z = (0.5 * torch.abs(c)).reshape(-1)
    dev = z.device
    t = _TRUNC
    K = _PI * _PI / 8.0 + 0.5 * z * z
    logp = torch.log(_PI / (2.0 * K)) - K * t
    sqt = math.sqrt(t)
    logq = math.log(2.0) + torch.logaddexp(
        -z + torch.special.log_ndtr((z * t - 1.0) / sqt),
        z + torch.special.log_ndtr(-(z * t + 1.0) / sqt))
    ratio_exp = torch.exp(logp - torch.logaddexp(logp, logq))

    zsafe = torch.clamp(z, min=1e-6)
    X = torch.where(z < 1e-6, torch.ones_like(z), torch.tanh(zsafe) / zsafe)
    idx = torch.arange(z.numel(), device=dev)
    for _ in range(_MAX_OUTER):
        if idx.numel() == 0:
            break
        n = idx.shape
        branch_exp = (torch.rand(n, generator=generator, device=dev)
                      < ratio_exp[idx])
        Xprop = t + _exponential(n, generator, dev) / K[idx]
        ok = branch_exp.clone()
        ig = (~branch_exp).nonzero().squeeze(1)
        if ig.numel():
            Xig, ig_ok = _trunc_inv_gauss(z[idx[ig]], generator)
            Xprop[ig] = Xig
            ok[ig] = ig_ok
        acc = ok & _series_accept(Xprop, generator)
        X[idx[acc]] = Xprop[acc]
        idx = idx[~acc]
    return (0.25 * X).reshape(c.shape)


def pg_draw_unit(c: torch.Tensor, generator: torch.Generator):
    """PG(1, c) draws: kernel K1 for a CUDA tensor, the plain version for a
    CPU tensor. On CUDA the kernel's Philox (seed, offset) pair is drawn
    from `generator`; pass a CPU generator to keep that draw off the
    device stream."""
    if c.is_cuda:
        from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
        seed, offset = torch.randint(
            0, 2 ** 62, (2,), generator=generator,
            device=generator.device).tolist()
        return pg_devroye_cuda(c, seed, offset)
    if c.device.type != "cpu":
        raise ValueError(f"pg_draw_unit: no PG sampler for device {c.device}")
    return pg_devroye_plain(c, generator)
