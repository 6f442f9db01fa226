"""The network priors in float64: the per-edge hyperparameters a sweep
gives the weight update, and the prior's own Gibbs move.

Erdos-Renyi: rho ~ Beta(a + #edges, b + #non-edges), then the shared
weight prior (mu, Sigma) from its normal-inverse-Wishart posterior over
the active edges. Latent distance: logit rho_ij = gamma - |l_i - l_j|^2,
(l, gamma) moved by hmc_iters leapfrog trajectories of hmc_steps steps
each with a Metropolis test (Hoff, Raftery and Handcock 2002's model),
then (mu, Sigma) as above per chain.
"""
from __future__ import annotations

import math

import torch

from gibbsbench.reference import samplers

F64 = torch.float64


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


def _weight_prior(state, N: int, B: int, dev):
    mu = state.mu.to(dev, F64)
    Lam = torch.linalg.inv(state.Sigma.to(dev, F64))
    return mu.expand(N, N, B), Lam.expand(N, N, B, B)


def edge_hypers(prior: dict, network: str, states: list, N: int, B: int,
                dev) -> dict:
    """The per-edge priors over the lanes of `states` (one network state
    a chain; each chain's N lanes in turn)."""
    mus, Lams, lrhos = [], [], []
    for s in states:
        mu, Lam = _weight_prior(s, N, B, dev)
        if network == "erdos_renyi":
            rho = s.rho.to(dev, F64).clamp(1e-5, 1 - 1e-5)
            lrho = _logit(rho).expand(N, N)
        else:
            L = s.L.to(dev, F64)
            d2 = ((L[:, None, :] - L[None, :, :]) ** 2).sum(-1)
            lrho = torch.clamp(s.gamma.to(dev, F64) - d2, -15.0, 15.0)
        mus.append(mu)
        Lams.append(Lam)
        lrhos.append(lrho)
    C = len(states)
    lam_b = 1.0 / prior["sigma_bias"] ** 2
    return {"mu": torch.cat(mus, 1), "Lam": torch.cat(Lams, 1),
            "lrho": torch.cat(lrhos, 1),
            "mu_b": torch.full((C * N,), float(prior["mu_bias"]), dtype=F64,
                               device=dev),
            "lam_b": torch.full((C * N,), lam_b, dtype=F64, device=dev)}


def _masked_stats(W, A):
    W, A = W.to(F64).cpu(), A.to(F64).cpu()
    m = A[..., None]
    n = A.sum()
    xbar = (m * W).sum(dim=(0, 1)) / max(float(n), 1e-12)
    diffs = (W - xbar) * m
    return float(n), xbar, torch.einsum("ijb,ijc->bc", diffs, diffs)


def niw_draw(prior: dict, state, W, A, B: int) -> list:
    """(mu, Sigma) from the NIW posterior of W's active edges, from a host
    generator in `state`: [((mu, Sigma), state after), ...]."""
    n, xbar, S = _masked_stats(W, A)
    nu0 = prior["niw_nu0"] if prior.get("niw_nu0") is not None else B + 2
    post = samplers.niw_posterior(
        torch.full((B,), float(prior["niw_mu0"]), dtype=F64),
        float(prior["niw_kappa0"]), float(nu0),
        torch.eye(B, dtype=F64) * prior["niw_psi0"], n, xbar, S)
    return samplers.niw(state, *post)


def er_resample(prior: dict, call: dict, B: int) -> list:
    """The Erdos-Renyi move from the program's (A, W) and its host
    generator's state on entry: every outcome a float32 run can reach,
    [{"rho", "mu", "Sigma"}, ...]."""
    A, W = call["A"], call["W"]
    outs = [({}, call["host_gen"])]
    if prior.get("learn_rho", True):
        n = float(A.to(F64).sum())
        outs = [({"rho": r}, s) for _, st in outs for r, s in samplers.beta(
            prior["a_rho"] + n, prior["b_rho"] + A.numel() - n, st)]
    if prior.get("learn_weight_prior", True):
        outs = [(dict(o, mu=mu, Sigma=Sigma), s) for o, st in outs
                for (mu, Sigma), s in niw_draw(prior, st, W, A, B)]
    return [o for o, _ in outs]


class _Potential:
    """U(l, gamma) = -(sum_ij A_ij lrho_ij - log(1 + e^lrho_ij)
    - |l|^2 / (2 sigma_l^2) - gamma^2 / (2 sigma_gamma^2)) and its
    gradient."""

    def __init__(self, A, sigma_l, sigma_gamma):
        self.A, self.sl2, self.sg2 = A, sigma_l ** 2, sigma_gamma ** 2

    def lrho(self, L, gm):
        return gm - ((L[:, None, :] - L[None, :, :]) ** 2).sum(-1)

    def U(self, L, gm):
        lr = self.lrho(L, gm)
        ll = (self.A * lr - torch.nn.functional.softplus(lr)).sum()
        return -(ll - 0.5 * (L * L).sum() / self.sl2
                 - 0.5 * gm * gm / self.sg2)

    def grad(self, L, gm):
        w = torch.sigmoid(self.lrho(L, gm)) - self.A
        ws = w + w.T
        gL = 2.0 * (ws @ L - ws.sum(-1, keepdim=True) * L) + L / self.sl2
        return gL, w.sum() + gm / self.sg2


def hmc_leaves(prior: dict, L0, g0, A, mom_L, mom_g, u_hmc, n_accept: int,
               delta: float, max_nodes: int = 4096):
    """Every end state of one chain's trajectories that a float32 run can
    reach: each Metropolis test whose float64 log-ratio lies within
    `delta` of log u is taken both ways, and only paths with the
    program's number of accepts are kept. Returns [(L, gamma), ...]."""
    pot = _Potential(A, prior["sigma_l"], prior["sigma_gamma"])
    eps, steps, iters = prior["hmc_eps"], prior["hmc_steps"], len(u_hmc)
    leaves, stack, nodes = [], [(0, L0, g0, 0)], 0
    while stack:
        k, L, gm, na = stack.pop()
        if na > n_accept or na + iters - k < n_accept:
            continue
        if k == iters:
            leaves.append((L, gm))
            continue
        nodes += 1
        if nodes > max_nodes:
            break
        gL, gg = pot.grad(L, gm)
        mL, mg = mom_L[k], mom_g[k]
        K0 = 0.5 * ((mL * mL).sum() + mg * mg)
        mL, mg = mL - 0.5 * eps * gL, mg - 0.5 * eps * gg
        Ln, gn = L, gm
        for _ in range(steps):
            Ln, gn = Ln + eps * mL, gn + eps * mg
            gLn, ggn = pot.grad(Ln, gn)
            mL, mg = mL - eps * gLn, mg - eps * ggn
        mL, mg = mL + 0.5 * eps * gLn, mg + 0.5 * eps * ggn
        K1 = 0.5 * ((mL * mL).sum() + mg * mg)
        log_ratio = float(pot.U(L, gm) + K0 - pot.U(Ln, gn) - K1)
        lu = math.log(float(u_hmc[k]))
        for acc in ((True, False) if abs(lu - log_ratio) < delta
                    else (lu < log_ratio,)):
            stack.append((k + 1, Ln if acc else L, gn if acc else gm,
                          na + acc))
    return leaves


def ld_noise(dev_state, dev, C: int, N: int, prior: dict):
    """The move's momenta and uniforms, drawn as the move draws them."""
    g = torch.Generator(device=dev)
    g.set_state(dev_state)
    k, dim = prior["hmc_iters"], prior["dim"]
    if prior.get("swap_moves", 0) or prior.get("relocate_moves", 0):
        raise NotImplementedError("swap and relocation moves")
    mom_L = torch.randn((C, k, N, dim), generator=g, device=dev)
    mom_g = torch.randn((C, k), generator=g, device=dev)
    u_hmc = torch.rand((C, k), generator=g, device=dev)
    return mom_L.to(F64), mom_g.to(F64), u_hmc.to(F64)
