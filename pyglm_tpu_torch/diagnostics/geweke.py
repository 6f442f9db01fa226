"""Geweke joint-distribution test for the Gibbs sweep (PyTorch counterpart
of ``pyglm_tpu/diagnostics/geweke.py``).

The successive-conditional simulator alternates
    data   ~ p(Y | theta)        (forward generation)
    theta  ~ Gibbs(theta | Y)    (one full sweep)
whose stationary marginal over theta must equal the *prior*: a bug in any
conditional update, in a kernel's arithmetic or in its use of random
numbers shows as a drift away from the prior marginals, which no test of a
kernel against its plain version can mask.

PyTorch runs eagerly, so the chain is a host loop of generate -> design ->
sweep on explicit generators; the per-iteration summaries stay on the
chain's device until the end. On the card the sweep runs the kernels of
its configuration (``models.weights.LAST_SS_PATH`` and
``ops._build.LAUNCHES`` say which).
"""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.ensemble import chain_generators
from pyglm_tpu_torch.models.sweep import (
    GLMData, init_state_from_prior, make_generator, make_gibbs_sweep,
)
from pyglm_tpu_torch.ops.basis import design_matrix
from pyglm_tpu_torch.utils.utils import require_device


def geweke_chain(seed: int, obs, network, N: int, B: int, basis, T: int,
                 spike_slab: bool, n_iters: int = 2000,
                 precision: str = "highest", group: int | None = None,
                 with_llc: bool = False, device="cuda"):
    """Run the successive-conditional simulator on generators seeded from
    `seed`; returns per-iteration parameter summaries as a host numpy dict.

    Collected series: bias (n, N), A_density, n_active, W_sum, W_sq and
    y_max (n,), plus rho (ER and dense (n,), SBM (n, K, K)), prior_mu and
    prior_Sigma ((n, B) and (n, B, B); per block pair for the SBM) where
    the network state has them, the SBM's pi and label fractions c_frac
    (n, K), and each observation aux entry (r (n, N) for NB, eta (n, N)
    for the Gaussian).

    ``precision`` and ``group`` pass to the sweep, so the same chain runs
    either spike-and-slab loop at any mode. ``with_llc=True`` registers each
    regenerated dataset's ll cache, so that the cache-reading conditionals
    (NB's collapsed-CRT r update, the cached normaliser) face the test.
    """
    dev = require_device(device)
    basis = np.asarray(basis, np.float32)
    gens = chain_generators(seed, dev)
    sweep = make_gibbs_sweep(obs, network, N, B, spike_slab, group=group,
                             precision=precision)
    gen = make_generator(obs, N, B)
    state = init_state_from_prior(gens, obs, network, N, B, spike_slab, dev)

    series = {}
    for _ in range(n_iters):
        Y, _ = gen(gens.device, state, basis, T)
        Xf = design_matrix(Y, basis)
        data = GLMData(Y=Y, Xf=Xf, Xt=Xf.T.contiguous(),
                       llc=obs.ll_cache(Y) if with_llc else None)
        state, _ = sweep(gens, state, (data,))
        n_act = state.A.sum()
        out = {"bias": state.b, "A_density": n_act / state.A.numel(),
               "n_active": n_act, "W_sum": state.W.sum(),
               "W_sq": (state.W ** 2).sum(),
               # The first thing to read when a count-family chain
               # corrupts: an autoregressive runaway shows here.
               "y_max": Y.max()}
        net = state.net
        if hasattr(net, "rho"):
            out["rho"] = net.rho
        if hasattr(net, "mu") and hasattr(net, "Sigma"):
            out["prior_mu"] = net.mu
            out["prior_Sigma"] = net.Sigma
        if hasattr(net, "c"):
            out["pi"] = net.pi
            out["c_frac"] = torch.bincount(
                net.c, minlength=net.pi.shape[0]).float() / N
        if isinstance(state.aux, dict):
            out.update(state.aux)
        for k, v in out.items():
            series.setdefault(k, []).append(v.detach())
    return {k: torch.stack(v).cpu().numpy() for k, v in series.items()}


def ks_two_sample(samples, reference, thin: int = 1):
    """Two-sample KS statistic between (optionally thinned) samples and a
    reference sample. Returns (ks, threshold) at alpha ~ 1e-4
    (c(alpha) ~ 1.95), with the thinned count as the effective sample size:
    conservative only if thinning clears the chain's autocorrelation time
    (for iid samplers use thin=1)."""
    s = np.sort(np.asarray(samples, np.float64)[::thin].ravel())
    p = np.sort(np.asarray(reference, np.float64).ravel())
    grid = np.concatenate([s, p])
    cdf_s = np.searchsorted(s, grid, side="right") / len(s)
    cdf_p = np.searchsorted(p, grid, side="right") / len(p)
    ks = float(np.max(np.abs(cdf_s - cdf_p)))
    n_eff = len(s) * len(p) / (len(s) + len(p))
    thresh = 1.95 / np.sqrt(n_eff)
    return ks, thresh


def tau_int(x, c: float = 5.0) -> float:
    """Integrated autocorrelation time of a series (Sokal windowing), as
    ``tests/test_geweke_tpu.py`` computes it."""
    x = np.asarray(x, np.float64)
    x = x - x.mean()
    n = x.size
    acf = np.correlate(x, x, mode="full")[n - 1:] / (x.var() * n + 1e-30)
    tau = 1.0
    for m in range(1, n // 4):
        tau += 2.0 * acf[m]
        if m >= c * tau:
            break
    return max(tau, 1.0)


def prior_gates(series, net: dict, B: int, burn: int, z_max: float = 5.0,
                weights: bool = False, r_prior=None, max_y=None,
                eta_prior=None, sbm_prior=None):
    """The gates of ``tests/test_geweke_tpu.py`` on a geweke_chain's series
    after `burn` iterations, each n_eff discounted by the series' tau_int:
    [(marginal, ok, numbers)].

    `net` holds the prior's (sigma_w, mu_bias, sigma_bias, and rho_init for
    the ER prior). The bias marginal (z < z_max, variance ratio within
    0.3) always; the adjacency density (z < z_max) under the ER prior
    (`net` has rho_init); with `weights`, the active weights' second
    moment (ratio within 1 +- max(5 sqrt(2 / n_draws), 0.05)) and mean
    (within 6 standard errors); with `r_prior` = (a_r, b_r), the NB
    dispersion's Gamma prior (z < z_max, variance ratio within 0.35, r
    finite, counts at most `max_y`); with `eta_prior` = (a_eta, b_eta),
    the Gaussian noise variance's inverse-gamma prior (z < z_max, eta
    finite); with `sbm_prior` = (a_rho, b_rho), the SBM's block rho (its
    Beta prior, z < z_max), pi_0 (K = 2, alpha_pi = 1: Beta(1, 1), z <
    z_max, variance ratio within 0.35) and the label fraction of block 0
    (mean 1/2 by symmetry, z < z_max on its own spread), as
    tests/test_geweke.py::test_geweke_sbm."""
    def z(mean_emp, mean_true, var_true, n_eff):
        return abs(mean_emp - mean_true) / np.sqrt(var_true
                                                   / max(n_eff, 2.0))

    out = []
    b = series["bias"][burn:]
    N = b.shape[1]
    tau = tau_int(b.mean(axis=1))
    zb = z(b.mean(), net["mu_bias"], net["sigma_bias"] ** 2,
           b.shape[0] * N / tau)
    vb = b.var() / net["sigma_bias"] ** 2
    out.append(("bias", zb < z_max and abs(vb - 1) < 0.3,
                f"z {zb:.2f}, var ratio {vb:.3f}, tau {tau:.1f}"))
    if "rho_init" in net:
        dens = series["A_density"][burn:]
        tau = tau_int(dens)
        rho = net["rho_init"]
        za = z(dens.mean(), rho, rho * (1 - rho),
               dens.shape[0] * N ** 2 / tau)
        out.append(("adjacency", za < z_max,
                    f"z {za:.2f}, density {dens.mean():.4f}, "
                    f"tau {tau:.1f}"))
    if eta_prior is not None:
        a_e, b_e = eta_prior
        eta = series["eta"][burn:]
        m_true = b_e / (a_e - 1)
        v_true = b_e ** 2 / ((a_e - 1) ** 2 * (a_e - 2))
        tau = tau_int(eta.mean(axis=1))
        ze = z(eta.mean(), m_true, v_true, eta.shape[0] * N / tau)
        out.append(("eta", ze < z_max and np.isfinite(series["eta"]).all(),
                    f"z {ze:.2f}, mean {eta.mean():.4f} (prior "
                    f"{m_true:.4f}), tau {tau:.1f}"))
    if sbm_prior is not None:
        a_rho, b_rho = sbm_prior
        rho = series["rho"][burn:]
        m_true = a_rho / (a_rho + b_rho)
        v_true = a_rho * b_rho / ((a_rho + b_rho) ** 2
                                  * (a_rho + b_rho + 1))
        tau = tau_int(rho.mean(axis=(1, 2)))
        zr = z(rho.mean(), m_true, v_true, rho[..., 0, 0].size
               * rho[0].size / tau)
        out.append(("block rho", zr < z_max,
                    f"z {zr:.2f}, mean {rho.mean():.4f}, tau {tau:.1f}"))
        pi0 = series["pi"][burn:, 0]
        tau = tau_int(pi0)
        zp = z(pi0.mean(), 0.5, 1.0 / 12.0, pi0.size / tau)
        vp = pi0.var() * 12.0
        out.append(("pi", zp < z_max and abs(vp - 1) < 0.35,
                    f"z {zp:.2f}, var ratio {vp:.3f}, tau {tau:.1f}"))
        cf0 = series["c_frac"][burn:, 0]
        tau = tau_int(cf0)
        zc = z(cf0.mean(), 0.5, cf0.var() + 1e-12, cf0.size / tau)
        out.append(("labels", zc < z_max,
                    f"z {zc:.2f}, block-0 fraction {cf0.mean():.4f}, "
                    f"tau {tau:.1f}"))
    if weights:
        wsq = series["W_sq"][burn:]
        nact = series["n_active"][burn:]
        ratio = wsq.sum() / (nact.sum() * B * net["sigma_w"])
        tau = tau_int(wsq / np.maximum(nact, 1.0))
        n_draws = nact.sum() * B / tau
        lim = max(5.0 * np.sqrt(2.0 / n_draws), 0.05)
        est = series["W_sum"][burn:].sum() / (nact.sum() * B)
        se = np.sqrt(net["sigma_w"] / n_draws)
        out.append(("weights", abs(ratio - 1) < lim and abs(est) < 6 * se,
                    f"second-moment ratio {ratio:.4f} (limit 1 +- "
                    f"{lim:.4f}), mean {est:.5f} ({abs(est) / se:.2f} se), "
                    f"tau {tau:.1f}"))
    if r_prior is not None:
        a_r, b_r = r_prior
        r = series["r"][burn:]
        m_true, v_true = a_r / b_r, a_r / b_r ** 2
        tau = tau_int(r.mean(axis=1))
        zr = z(r.mean(), m_true, v_true, r.shape[0] * N / tau)
        vr = r.var() / v_true
        out.append(("r", zr < z_max and abs(vr - 1) < 0.35
                    and np.isfinite(series["r"]).all()
                    and series["y_max"].max() <= max_y,
                    f"z {zr:.2f}, var ratio {vr:.3f}, tau {tau:.1f}, y_max "
                    f"{series['y_max'].max():.0f}"))
    return out
