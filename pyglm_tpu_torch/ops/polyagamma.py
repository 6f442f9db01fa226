"""Polya-Gamma PG(b, c) draws (PyTorch counterpart of
``pyglm_tpu/ops/polyagamma.py``).

- :func:`pg_mean`, :func:`pg_var`: closed-form moments, stable at c -> 0.
- :func:`pg_devroye_plain`: exact PG(1, c) by Devroye's alternating-series
  rejection sampler (Polson-Scott-Windle 2013, Alg. 1), the plain PyTorch
  version of kernel ``csrc/pg_devroye.cu``. It follows the JAX package's
  XLA sampler: log-space mixture weight q via ``logaddexp``, truncated
  inverse-Gaussian proposals below t = 0.64, exponential above, and an
  alternating-series test with ``_N_SERIES`` terms. Where JAX masks the whole
  batch every round, this version redraws only the pending elements.
- :func:`pg_draw_unit` (also :data:`pg_devroye`): a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.
- :func:`pg_gamma_series_plain`: PG(b, c) for real b > 0 by the gamma
  series truncated at ``_GAMMA_K`` terms plus a three-moment shifted-gamma
  tail, the plain version of kernel ``csrc/pg_gamma.cu``; with a finite
  ``normal_cutoff`` it draws :func:`pg_normal_approx` where b >= cutoff.
- :func:`polya_gamma`: the hybrid sampler, dispatching each element to one
  regime (zero, normal approximation, gamma series, Devroye);
  :func:`pg_gamma_series`, the gamma series alone.

PG(1, c) = J*(1, c/2) / 4;
PG(b, c) = (1/(2 pi^2)) sum_k g_k / ((k-1/2)^2 + c^2/(4 pi^2)), g_k ~ Gamma(b).
"""
from __future__ import annotations

import math

import torch

from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.linalg import sample_gamma

_PI = math.pi
_TRUNC = 0.64          # Devroye proposal truncation point t
_MAX_OUTER = 64        # proposal rounds (acceptance >= 0.9992 per round)
_MAX_INNER = 64        # truncated-inverse-Gaussian rounds
_N_SERIES = 4          # alternating-series terms: a_3/a_0 < 1e-17
_GAMMA_K = 4           # gamma-series terms drawn exactly (the TPU kernel's K)
# The reference's hybrid dispatch takes the normal approximation from
# b ~ 170 on; the gamma series is valid below it at b-independent cost.
_NORMAL_CUTOFF = 170.0
_METHODS = ("auto", "real", "devroye", "gamma", "normal")


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


def _fma_residual(a, b, p):
    """fmaf(a, b, -p) for float32 a, b, p with p = fl(a b): the rounding
    error of the product, exact (the product of two float32 values is
    exact in float64, and so is its difference from p)."""
    return (a.double() * b.double() - p.double()).float()


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


# Constants of the mixture weight: t/2 and pi^2 t / 8 as float32 values
# plus the float32 rounding of their error, and e^{pi^2 t / 8 - 1/(2t)}.
_HALF_T = torch.tensor(0.5 * _TRUNC, dtype=torch.float32)
_HALF_T_LO = float(0.5 * _TRUNC - float(_HALF_T))
_C1 = torch.tensor(_PI * _PI * _TRUNC / 8.0, dtype=torch.float32)
_C1_LO = float(_PI * _PI * _TRUNC / 8.0 - float(_C1))
_C2 = math.exp(_PI * _PI * _TRUNC / 8.0 - 1.0 / (2.0 * _TRUNC))


def mixture_weight(z):
    """Weight p / (p + q) of the exponential branch of Devroye's proposal
    for J*(1, z), in float32 arithmetic (kernel K1 forms it alike):

      p = pi/(2K) e^{-K t},  K = pi^2/8 + z^2/2,
      q = 2 [e^{-z} Phi(a) + e^{z} Phi(-b)],  a, b = (z t -+ 1)/sqrt t.

    With Phi(-b) = erfcx(b/sqrt 2) e^{-b^2/2} / 2, e^{z} Phi(-b) =
    erfcx(b/sqrt 2) e^{-z^2 t/2 - 1/(2t)} / 2 never overflows, and
    q/p = (2K/pi) [2 Phi(a) e^{E} + erfcx(b/sqrt 2) e^{pi^2 t/8 - 1/(2t)}]
    with E = pi^2 t/8 + z^2 t/2 - z. E is carried as an unevaluated sum of
    two float32 values (exact products by FMA residuals), since e^{E}
    turns E's absolute error into a relative one. Within 1e-6 relative of
    the float64 weight wherever that is a normal float32 (z up to ~18.5);
    beyond, both are below 1.2e-38 (q/p overflows to inf: weight 0).
    Phi(a) switches from erfc(-a/sqrt 2)/2 to 1 - erfc(a/sqrt 2)/2 at
    a = 0, z = 1/t."""
    z = torch.as_tensor(z, dtype=torch.float32)
    zz = z * z
    zz_e = _fma_residual(z, z, zz)
    s = zz * _HALF_T
    s_e = _fma_residual(zz, _HALF_T, s) + (zz * _HALF_T_LO + zz_e * _HALF_T)
    d, d_e = _two_sum(torch.full_like(z, float(_C1)), -z)
    e, e_e = _two_sum(s, d)
    e_e = e_e + (s_e + (d_e + _C1_LO))
    sqt = math.sqrt(_TRUNC)
    a = (z * _TRUNC - 1.0) / sqt
    b = (z * _TRUNC + 1.0) / sqt
    r2 = 1.0 / math.sqrt(2.0)
    phi = torch.where(a < 0, 0.5 * torch.special.erfc(-a * r2),
                      1.0 - 0.5 * torch.special.erfc(a * r2))
    K = _PI * _PI / 8.0 + 0.5 * zz
    r = (2.0 / _PI) * K * (2.0 * phi * (torch.exp(e) * (1.0 + e_e))
                           + _C2 * torch.special.erfcx(b * r2))
    return 1.0 / (1.0 + r)


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
    ratio_exp = mixture_weight(z)

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
        return pg_devroye_cuda(c, *_build.philox_seed(generator))
    if c.device.type != "cpu":
        raise ValueError(f"pg_draw_unit: no PG sampler for device {c.device}")
    return pg_devroye_plain(c, generator)


# The JAX package's name of its exact PG(1, c) sampler.
pg_devroye = pg_draw_unit


# ---------------------------------------------------------------------------
# Gamma-series sampler for general b > 0
# ---------------------------------------------------------------------------

def _tail_sums(a, K: int):
    """(S1, S2, S3) = sum_{k>K} 1/d_k, 1/d_k^2, 1/d_k^3 with
    d_k = (k-1/2)^2 + a^2, by midpoint-rule integrals plus the first
    Euler-Maclaurin correction, in the JAX package's float32 formulas. The
    exact S2/S3 cancel catastrophically for small a, so their Taylor series
    take over below a = 0.5. Integer powers are written as the products
    XLA evaluates for ``x ** n``."""
    Kf = float(K)
    asafe = torch.clamp(a, min=1e-12)
    small = a < 0.5
    a2 = a * a
    a4 = a2 * a2
    aK = a / Kf
    aK2 = aK * aK
    at = torch.atan(asafe / Kf)
    s2 = asafe * asafe
    s4 = s2 * s2
    S1 = torch.where(small, (1.0 - aK2 / 3.0 + aK2 * aK2 / 5.0) / Kf,
                     at / asafe)
    S2_exact = at / (2.0 * (asafe * s2)) - Kf / (2.0 * s2 * (Kf * Kf + s2))
    S2_series = (1.0 / (3.0 * Kf ** 3) - 2.0 * a2 / (5.0 * Kf ** 5)
                 + 3.0 * a4 / (7.0 * Kf ** 7))
    S2 = torch.where(small, S2_series, S2_exact)
    d_K = Kf * Kf + s2
    S3_exact = (3.0 * at / (8.0 * (asafe * s4))
                - Kf / (4.0 * s2 * d_K * d_K)
                - 3.0 * Kf / (8.0 * s4 * d_K))
    S3_series = (1.0 / (5.0 * Kf ** 5) - 3.0 * a2 / (7.0 * Kf ** 7)
                 + 2.0 * a4 / (3.0 * Kf ** 9))
    S3 = torch.where(small, S3_series, S3_exact)
    dKa = Kf * Kf + a2
    S1 = S1 - (2.0 * Kf / 24.0) / (dKa * dKa)
    S2 = S2 - (4.0 * Kf / 24.0) / (dKa * dKa * dKa)
    S3 = S3 - (6.0 * Kf / 24.0) / (dKa * dKa * dKa * dKa)
    return S1, S2, S3


def _f32_pair(b, c):
    """b and c as contiguous float32 tensors of their broadcast shape, on
    c's device."""
    c = torch.as_tensor(c, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=c.device)
    return tuple(x.contiguous() for x in torch.broadcast_tensors(b, c))


def pg_normal_approx(b, c, generator: torch.Generator):
    """Gaussian approximation PG(b, c) ~ N(mean, var), floored at 1e-30
    (the reference's hybrid dispatch uses it for b >~ 170; moment error
    O(1/b)). Draws on `generator`'s device."""
    m = pg_mean(b, c)
    v = pg_var(b, c)
    x = m + torch.sqrt(v) * torch.randn(m.shape, generator=generator,
                                        device=m.device)
    return torch.clamp(x, min=1e-30)


def _gamma_series(b, c, generator):
    """The truncated series plus its tail, for flat b > 0."""
    bs = torch.clamp(b, min=1e-6)
    a = torch.abs(c) / (2.0 * _PI)
    ks = (torch.arange(_GAMMA_K, dtype=torch.float32, device=b.device)
          + 0.5) ** 2
    d = ks + (a * a)[:, None]
    g = sample_gamma(bs[:, None].expand(-1, _GAMMA_K), generator)
    s = torch.sum(g / d, dim=-1) / (2.0 * _PI * _PI)
    # The tail k > K as delta + Gamma(alpha) / beta, matching its first
    # three moments (third cumulants of the terms add: mu3 = 2 b S3 /
    # (2 pi^2)^3). Cauchy-Schwarz (S2^2 <= S1 S3) keeps the shift delta
    # >= 0, so the match stays on the positive support.
    S1, S2, S3 = _tail_sums(a, _GAMMA_K)
    m_t = bs * S1 / (2.0 * _PI * _PI)
    v_t = bs * S2 / (4.0 * _PI ** 4)
    mu3_t = 2.0 * bs * S3 / (2.0 * _PI * _PI) ** 3
    beta = 2.0 * v_t / torch.clamp(mu3_t, min=1e-30)
    alpha = v_t * beta * beta
    delta = torch.clamp(m_t - alpha / beta, min=0.0)
    return s + delta + sample_gamma(alpha, generator) / beta


def pg_gamma_series_plain(b, c, generator: torch.Generator,
                          normal_cutoff: float = math.inf):
    """PG(b, c) for real b, elementwise over the broadcast of b and c: the
    normal approximation where b >= `normal_cutoff`, else 0 where b <= 0,
    else the gamma series with K = ``_GAMMA_K`` exact Gamma(max(b, 1e-6))
    terms (Marsaglia-Tsang, :func:`sample_gamma`) and the moment-matched
    tail. With the default cutoff this is the JAX package's
    ``pg_gamma_series(key, b, c, K=4)``. Draws on `generator`'s device.

    For b << 1 most Gamma(b) terms underflow to 0 in float32 (as they do in
    the JAX sampler); the tail's shift delta, proportional to b, keeps
    every draw > 0, which the sweep's psi = (kappa - u) / omega needs.
    """
    b, c = _f32_pair(b, c)
    out = torch.zeros_like(c)
    normal = b >= normal_cutoff
    series = (b > 0) & ~normal
    out[normal] = pg_normal_approx(b[normal], c[normal], generator)
    out[series] = _gamma_series(b[series], c[series], generator)
    return out


def _gamma_or_normal(b, c, generator, normal_cutoff):
    """Kernel K4 for CUDA tensors, its plain version for CPU tensors."""
    if c.is_cuda:
        from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
        return pg_gamma_series_cuda(b, c, *_build.philox_seed(generator),
                                    normal_cutoff=normal_cutoff)
    if c.device.type != "cpu":
        raise ValueError(f"polya_gamma: no PG sampler for device {c.device}")
    return pg_gamma_series_plain(b, c, generator, normal_cutoff)


def polya_gamma(b, c, generator: torch.Generator, method: str = "auto"):
    """Hybrid PG(b, c) sampler over the broadcast of b and c.

    method:
      "auto"    -- 0 where b <= 0, the normal approximation where b >= 170,
                   exact Devroye (K1) where b == 1, the gamma series (K4)
                   elsewhere;
      "real"    -- like "auto" without the Devroye regime, for families
                   whose b is generically non-integer (NB's b = y + r);
      "devroye" -- exact PG(1, c) for every element (b is ignored);
      "gamma"   -- the gamma series wherever b > 0, 0 elsewhere;
      "normal"  -- the normal approximation for every element.

    Each element is drawn once, in its regime (the JAX package draws the
    normal and the gamma value for every element and overlays them). K4
    takes the zero/normal/gamma choice itself, so "real" and "gamma" cost
    no host sync; "auto" counts the b == 1 elements on the host once. On
    CUDA the kernels' Philox seeds come from `generator` (pass a CPU
    generator); on the CPU the plain versions draw on it.
    """
    if method not in _METHODS:
        raise ValueError(f"unknown PG method {method!r}; one of {_METHODS}")
    b, c = _f32_pair(b, c)
    if method == "devroye":
        return pg_draw_unit(c, generator)
    cutoff = {"gamma": math.inf, "normal": -math.inf}.get(method,
                                                           _NORMAL_CUTOFF)
    if method != "auto":
        return _gamma_or_normal(b, c, generator, cutoff)
    unit = b == 1.0
    n_unit = int(unit.sum())
    if n_unit == unit.numel():
        return pg_draw_unit(c, generator)
    if n_unit == 0:
        return _gamma_or_normal(b, c, generator, cutoff)
    out = torch.empty_like(c)
    out[unit] = pg_draw_unit(c[unit], generator)
    rest = ~unit
    out[rest] = _gamma_or_normal(b[rest], c[rest], generator, cutoff)
    return out


def pg_gamma_series(b, c, generator: torch.Generator):
    """PG(b, c) by the gamma series wherever b > 0, 0 elsewhere (the JAX
    package's ``pg_gamma_series``): kernel K4 for CUDA tensors, its plain
    version for CPU tensors; ``polya_gamma(..., method="gamma")``."""
    return polya_gamma(b, c, generator, method="gamma")
