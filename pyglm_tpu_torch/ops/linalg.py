"""Conjugate-update linear algebra and small samplers (PyTorch counterpart of
the main-path subset of ``pyglm_tpu/ops/linalg.py``).

Samplers take an explicit ``torch.Generator``. ``torch.distributions`` and
``torch._standard_gamma`` accept none, so the Gamma draws behind the
Bartlett chi-square terms and the Beta draw of rho come from
:func:`sample_gamma`, a Marsaglia-Tsang sampler built on
``torch.randn``/``torch.rand``.

The (inverse-)Wishart and NIW draws act on O(B^2) scalars. The model runs
them on the host, on a CPU generator (models/networks.py), so they add no
launches to a sweep on the card; every function here is device-generic,
except :func:`crt_sample`, which runs kernel K5 on a CUDA tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pyglm_tpu_torch.ops import _build

_SMALL_B_MAX = 8
_GAMMA_MAX_ROUNDS = 100     # Marsaglia-Tsang rounds; each accepts w.p. > 0.95


# ---------------------------------------------------------------------------
# Unrolled small-B Cholesky / triangular solves
# ---------------------------------------------------------------------------
# Pure elementwise arithmetic over the batch: at B <= 8 a batched LAPACK
# call per edge step would be launch-bound. The spike-and-slab kernel
# (csrc/ss_edge_scan.cu) unrolls the same recurrences per thread.

def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of (..., B, B) SPD matrices, unrolled over B."""
    B = A.shape[-1]
    if B > _SMALL_B_MAX:
        return torch.linalg.cholesky(A)
    L = [[None] * B for _ in range(B)]
    for j in range(B):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, B):
            s2 = A[..., i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv_d
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(B)],
                        dim=-1) for i in range(B)]
    return torch.stack(rows, dim=-2)


def solve_lower_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L x = b for lower-triangular (..., B, B) L and (..., B) b."""
    B = L.shape[-1]
    if B > _SMALL_B_MAX:
        return torch.linalg.solve_triangular(L, b[..., None],
                                             upper=False)[..., 0]
    x = [None] * B
    for i in range(B):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def solve_lower_t_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L^T x = b (upper solve through the lower factor)."""
    B = L.shape[-1]
    if B > _SMALL_B_MAX:
        return torch.linalg.solve_triangular(
            L.transpose(-1, -2), b[..., None], upper=True)[..., 0]
    x = [None] * B
    for i in range(B - 1, -1, -1):
        s = b[..., i]
        for k in range(i + 1, B):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


# ---------------------------------------------------------------------------
# Gamma / Beta draws with an explicit generator
# ---------------------------------------------------------------------------

def sample_gamma(alpha, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws, elementwise over a tensor of shapes alpha > 0.

    Marsaglia & Tsang (2000): for a >= 1, d = a - 1/3, c = 1/sqrt(9d),
    v = (1 + c x)^3 with x ~ N(0, 1), accept d v when
    log u < x^2/2 + d - d v + d log v. For a < 1 the draw for a + 1 is
    boosted by u^(1/a). Each element retries until it accepts (acceptance
    is above 0.95 per round for every a); only pending elements redraw.
    """
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=generator.device)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.arange(a.numel(), device=a.device)
    d_f, c_f = d.reshape(-1), c.reshape(-1)
    out_f = out.reshape(-1)
    for _ in range(_GAMMA_MAX_ROUNDS):
        if pending.numel() == 0:
            break
        dp, cp = d_f[pending], c_f[pending]
        x = torch.randn(pending.shape, generator=generator,
                        device=a.device)
        u = torch.rand(pending.shape, generator=generator, device=a.device)
        v = (1.0 + cp * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dp - dp * v
                        + dp * torch.log(torch.clamp(v, min=1e-30)))
        out_f[pending[ok]] = (dp * v)[ok]
        pending = pending[~ok]
    if pending.numel() != 0:
        raise RuntimeError("gamma sampler did not converge")
    u = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def sample_beta(a, b, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) as Ga / (Ga + Gb)."""
    ga = sample_gamma(a, generator)
    gb = sample_gamma(b, generator)
    return ga / (ga + gb)


def _crt_r(y, r):
    """r as a contiguous float32 (N,) vector on y's device, N = y's last
    dimension; a scalar r is broadcast."""
    N = y.shape[-1]
    r = torch.as_tensor(r, dtype=torch.float32, device=y.device).reshape(-1)
    if r.numel() == 1:
        r = r.expand(N)
    if r.numel() != N:
        raise ValueError(f"r must broadcast along y's last dimension "
                         f"{N}, got {r.numel()} values")
    return r.contiguous()


def crt_sample_plain(y, r, max_y: int, generator: torch.Generator):
    """Plain version of kernel K5: max_y passes of masked Bernoulli draws,
    l += 1[U < r/(r+i)] where i < y, as the JAX package's XLA loop does."""
    r = _crt_r(y, r)
    l = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    for i in range(max_y):
        u = torch.rand(y.shape, generator=generator, device=y.device)
        l += ((u < r / (r + i)) & (i < y)).to(torch.int32)
    return l


def crt_sample(y, r, max_y: int, generator: torch.Generator):
    """Chinese-restaurant-table counts l | y, r (Zhou & Carin's NB
    augmentation): l = sum_{i < y} Bern(r / (r + i)), elementwise over y
    (..., N) with r of shape (N,) or a scalar. `max_y` bounds y; larger
    counts seat tables only for i < max_y, as in the JAX package.

    Kernel K5 for a CUDA y (its Philox seed drawn from `generator`; pass a
    CPU generator), the plain loop for a CPU y; other devices raise."""
    if y.is_cuda:
        from pyglm_tpu_torch.ops.crt_cuda import crt_sample_cuda
        if y.dtype not in (torch.int32, torch.float32):
            y = y.to(torch.float32)
        return crt_sample_cuda(y.contiguous(), _crt_r(y, r), max_y,
                               *_build.philox_seed(generator))
    if y.device.type != "cpu":
        raise ValueError(f"crt_sample: no sampler for device {y.device}")
    return crt_sample_plain(y, r, max_y, generator)


# ---------------------------------------------------------------------------
# (Inverse-)Wishart / NIW
# ---------------------------------------------------------------------------

def sample_wishart(generator: torch.Generator, nu, S: torch.Tensor):
    """W ~ Wishart(nu, S) by the Bartlett decomposition (S = scale)."""
    dim = S.shape[-1]
    Ls = torch.linalg.cholesky(S)
    df = torch.as_tensor(nu, dtype=S.dtype, device=S.device) - torch.arange(
        dim, dtype=S.dtype, device=S.device)
    chi2 = 2.0 * sample_gamma(0.5 * df, generator)           # chi^2_{nu-i}
    A = torch.tril(torch.randn((dim, dim), generator=generator,
                               dtype=S.dtype, device=S.device), -1)
    A = A + torch.diag(torch.sqrt(chi2))
    LA = Ls @ A
    return LA @ LA.T


def sample_invwishart(generator: torch.Generator, nu, Psi: torch.Tensor):
    """Sigma ~ InverseWishart(nu, Psi): Sigma^{-1} ~ Wishart(nu, Psi^{-1})."""
    dim = Psi.shape[-1]
    eye = torch.eye(dim, dtype=Psi.dtype, device=Psi.device)
    Psi_inv = torch.linalg.solve(Psi, eye)
    Psi_inv = 0.5 * (Psi_inv + Psi_inv.T)
    W = sample_wishart(generator, nu, Psi_inv)
    Sigma = torch.linalg.solve(W, eye)
    return 0.5 * (Sigma + Sigma.T)


class NIWParams(NamedTuple):
    mu0: torch.Tensor     # (D,)
    kappa0: torch.Tensor  # ()
    nu0: torch.Tensor     # ()
    Psi0: torch.Tensor    # (D, D)


def niw_posterior(p: NIWParams, n, xbar, S) -> NIWParams:
    """Conjugate NIW posterior from sufficient stats (n, mean, centered
    scatter S). n = 0 returns the prior."""
    n = torch.as_tensor(n, dtype=p.mu0.dtype, device=p.mu0.device)
    kappa_n = p.kappa0 + n
    nu_n = p.nu0 + n
    xbar = torch.where(n > 0, xbar, p.mu0)
    mu_n = (p.kappa0 * p.mu0 + n * xbar) / kappa_n
    d = (xbar - p.mu0)[:, None]
    Psi_n = p.Psi0 + S + (p.kappa0 * n / kappa_n) * (d @ d.T)
    return NIWParams(mu_n, kappa_n, nu_n, Psi_n)


def sample_niw(generator: torch.Generator, p: NIWParams):
    """(mu, Sigma) ~ NIW(mu0, kappa0, nu0, Psi0)."""
    Sigma = sample_invwishart(generator, p.nu0, p.Psi0)
    C = torch.linalg.cholesky(Sigma / p.kappa0)
    z = torch.randn(p.mu0.shape, generator=generator, dtype=p.mu0.dtype,
                    device=p.mu0.device)
    return p.mu0 + C @ z, Sigma
