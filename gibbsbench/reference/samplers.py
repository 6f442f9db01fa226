"""Conjugate draws in float64 from the program's own random numbers.

Each sampler reads a torch CPU generator, set to the state the program's
generator had, with the very calls of the same shapes and dtype (float32)
that the program's sampler makes, and does its arithmetic in float64. A
rejection sampler's accept test is the one place where float32 rounding
can change the path: a test whose float64 margin lies within float32's
rounding of its terms is taken both ways, and each sampler returns every
draw a float32 run can reach, with the generator's state after it:
``[(draw, state), ...]``, the float64 path first. The algorithms are the
textbook ones: Marsaglia and Tsang (2000) for Gamma(a), boosted by
u^(1/a) for a < 1; Beta as Ga / (Ga + Gb); Wishart by Bartlett's
decomposition; the normal-inverse-Wishart by its conjugate update.
"""
from __future__ import annotations

import itertools

import torch

F64 = torch.float64
_ROUNDS = 100
# A float32 test rounds each of its terms (d ~ 1e4 in the weight prior's
# Wishart), so its margin is known to some ulps of their sum.
SLACK = 16 * 2.0 ** -23
# Tests of one round taken both ways, at most (each doubles the paths).
_MAX_AMBIGUOUS = 6


def _gen(state) -> torch.Generator:
    g = torch.Generator()
    g.set_state(state)
    return g


def gamma(alpha, state) -> list:
    """Gamma(alpha, 1), elementwise over a tensor of shapes, from a
    generator in `state`: [(draw, state after), ...]."""
    alpha = torch.as_tensor(alpha, dtype=F64)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = (a - 1.0 / 3.0).reshape(-1)
    c = 1.0 / torch.sqrt(9.0 * d)
    paths = []
    stack = [(state, torch.arange(a.numel()),
              torch.empty(a.numel(), dtype=F64), 0)]
    while stack:
        st, pending, out, rounds = stack.pop()
        g = _gen(st)
        if pending.numel() == 0:
            u = torch.rand(a.shape, generator=g).to(F64)
            o = out.reshape(a.shape)
            paths.append((torch.where(boost, o * u ** (1.0 / alpha), o),
                          g.get_state()))
            continue
        if rounds == _ROUNDS:
            raise RuntimeError("gamma draw did not accept")
        x = torch.randn(pending.shape, generator=g).to(F64)
        u = torch.rand(pending.shape, generator=g).to(F64)
        dp, cp = d[pending], c[pending]
        v = (1.0 + cp * x) ** 3
        lu, lv = torch.log(u), torch.log(torch.clamp(v, min=1e-30))
        rhs = 0.5 * x * x + dp - dp * v + dp * lv
        ok = (v > 0) & (lu < rhs)
        tol = SLACK * (lu.abs() + 0.5 * x * x + dp * (1 + v.abs() + lv.abs()))
        amb = ((v > 0) & ((lu - rhs).abs() < tol)).nonzero().flatten()
        amb = amb[:_MAX_AMBIGUOUS]
        nxt = g.get_state()
        flips = list(itertools.product((False, True), repeat=amb.numel()))
        for flip in reversed(flips):         # the float64 path on top
            okf = ok.clone()
            okf[amb[torch.tensor(flip, dtype=torch.bool)]] ^= True
            o = out.clone()
            o[pending[okf]] = (dp * v)[okf]
            stack.append((nxt, pending[~okf], o, rounds + 1))
    return paths


def beta(a, b, state) -> list:
    return [(ga / (ga + gb), s2) for ga, s1 in gamma(a, state)
            for gb, s2 in gamma(b, s1)]


def _sym(x):
    return 0.5 * (x + x.transpose(-1, -2))


def wishart(state, nu, S) -> list:
    D = S.shape[-1]
    Ls = torch.linalg.cholesky(S)
    df = torch.as_tensor(nu, dtype=F64) - torch.arange(D, dtype=F64)
    out = []
    for half_chi2, s1 in gamma(0.5 * df, state):
        g = _gen(s1)
        Z = torch.tril(torch.randn(S.shape, generator=g).to(F64), -1)
        LA = Ls @ (Z + torch.diag(torch.sqrt(2.0 * half_chi2)))
        out.append((LA @ LA.T, g.get_state()))
    return out


def niw_posterior(mu0, kappa0, nu0, Psi0, n, xbar, S):
    kn, nn = kappa0 + n, nu0 + n
    if n <= 0:
        xbar = mu0
    mun = (kappa0 * mu0 + n * xbar) / kn
    d = xbar - mu0
    return mun, kn, nn, Psi0 + S + (kappa0 * n / kn) * torch.outer(d, d)


def niw(state, mu, kappa, nu, Psi) -> list:
    """(mu, Sigma) ~ NIW: Sigma^{-1} ~ Wishart(nu, Psi^{-1}), then mu."""
    out = []
    for Wm, s1 in wishart(state, nu, _sym(torch.linalg.inv(Psi))):
        Sigma = _sym(torch.linalg.inv(Wm))
        C = torch.linalg.cholesky(Sigma / kappa)
        g = _gen(s1)
        z = torch.randn(mu.shape, generator=g).to(F64)
        out.append(((mu + C @ z, Sigma), g.get_state()))
    return out
