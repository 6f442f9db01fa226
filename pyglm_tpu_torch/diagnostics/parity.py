"""Chain-level posterior parity: the port's precision modes against each
other and against the f64 NumPy oracle (``reference/numpy_ref.py``), on the
data and priors of ``benchmarks/sr_parity.py``.

The protocol: N=8, B=4, L=10 (GB=32, so the fused spike-and-slab loop
runs), T=1500 bins from a seeded truth, 150 + 400 sweeps. Each pool is
PAR_C lane-stacked chains (``fit_ensemble``) on seeds of its own; each
chain contributes its posterior means of A, W_effective and the bias. Two
pools are held to each other by their max edge-marginal difference (within
``perm_band``) and by every edge's difference in standard errors of the two
pools' means; a pool is held to a pool of oracle chains at the tolerances
of ``tests/test_numpy_parity.py`` (``oracle_gates``).

``ORACLE_CONFIGS`` adds the other oracle configs of
``tests/test_numpy_parity.py`` (dense NIW, Gaussian, Binomial, SBM, latent
distance): the same planted data (by the port's generator), priors,
chain lengths and tolerances, the port's chains single
(:func:`config_port_means`, ``stacked=False``) or lane-stacked, the
oracle's from :func:`config_oracle_means`, compared by
:func:`config_compare` and :func:`config_gates`.

Run as a script, it measures how the chain-parity gates behave where
nothing is biased (needs a CUDA card):

    python -m pyglm_tpu_torch.diagnostics.parity [--high 8] [--default 2]
        [--sr 2] [--oracle 128] [--procs 7] [--out PATH]

It runs ``--high`` pools at "high" (seed bases 1, 101, 401, ...), the
other modes' pools, and ``--oracle`` oracle chains in ``--procs`` spawned
processes (one BLAS thread each), then prints one JSON object: every pair
of "high" pools against the chain-parity gates; every port pool against
every disjoint pool of ORC_C oracle chains; and the false-failure rates of
both gates over random disjoint draws of pools from all the "high" chains
and all the oracle chains. With ``--out PATH`` it also writes the readings
there and every chain's posterior means beside them (``PATH`` with
``.npz``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing as mp
import os
import subprocess
import time
from typing import NamedTuple

import numpy as np

PAR_N, PAR_B, PAR_L, PAR_T, PAR_BURN, PAR_KEEP = 8, 4, 10, 1500, 150, 400
# Chains per pool. Edge (3, 0) is bimodal here: each chain's marginal sits
# near 0 or near 1, so at 16 chains two unbiased pools differed there by up
# to 0.32. At 64 the difference of two pools has half that spread.
PAR_C = 64
# The chain-parity band: the PAR_PERM_Q quantile of the max edge-marginal
# difference over PAR_PERM random splits of the two pools' chains (they are
# exchangeable without a bias), and never above PAR_BAND_CAP, the oracle
# protocol's own tolerance.
PAR_PERM, PAR_PERM_Q, PAR_BAND_CAP = 10_000, 0.999, 0.22
PAR_Z = 5.0
PAR_NET = dict(rho_init=0.35, learn_rho=False, mu_bias=-1.2, sigma_bias=0.4,
               learn_weight_prior=False, sigma_w=0.8)
# The ladder of the tempered pool (tempered_pool): suggest_ladder(7.77, 4)
# rounded, 7.77 the sd of the log-likelihood over 300 sweeps (after 150)
# of one chain on this data (CPU), so adjacent swaps accept ~0.3.
TEMPER_BETAS = (0.43, 0.62, 0.81, 1.0)
# Oracle chains per pool, and tests/test_numpy_parity.py's tolerances.
ORC_C = 32
ORC_TOL = {"max_edge_marginal_diff": 0.22, "max_weight_mean_diff": 0.35,
           "max_bias_mean_diff": 0.25, "mean_edge_prob_diff": 0.06}
ORC_Z = 5.0
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def posterior_means(ref, Y, n_burn: int, n_keep: int):
    """n_burn + n_keep sweeps of a NumpyGLMReference on Y (T, N): the means
    over the kept sweeps of A, W_effective (A times W summed over the
    basis) and the bias."""
    Y = np.asarray(Y, np.float64)
    Xf = ref.design(Y)
    N = Y.shape[1]
    A = np.zeros((N, N)); W = np.zeros((N, N)); b = np.zeros(N)
    for it in range(n_burn + n_keep):
        ref.resample(Y, Xf)
        if it >= n_burn:
            A += ref.A / n_keep
            W += (ref.A[:, :, None] * ref.W).sum(-1) / n_keep
            b += ref.b / n_keep
    return A, W, b


def parity_data(device="cuda"):
    """The data of benchmarks/sr_parity.py: a SparseBernoulliGLM(PAR_N)
    truth (seed 123) generates PAR_T bins."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.ops.basis import cosine_basis
    return SparseBernoulliGLM(PAR_N, basis=cosine_basis(PAR_B, PAR_L),
                              seed=123, net_kwargs=PAR_NET,
                              device=device).generate(PAR_T, keep=False)


def parity_pool(Y, precision: str, s0: int, device="cuda"):
    """PAR_C lane-stacked chains at `precision` on seeds s0 .. s0+PAR_C-1:
    each chain's posterior means {"A", "W" (W_effective): (PAR_C, N, N),
    "b": (PAR_C, N)}, and the loop that ran."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops.basis import cosine_basis
    m = SparseBernoulliGLM(PAR_N, basis=cosine_basis(PAR_B, PAR_L), seed=0,
                           net_kwargs=PAR_NET, precision=precision,
                           device=device)
    m.add_data(Y)
    out = m.fit_ensemble(n_chains=PAR_C, n_burnin=PAR_BURN,
                         n_samples=PAR_KEEP, seeds=list(range(s0, s0 + PAR_C)))
    return ({"A": out["A"].mean(1), "W": out["W"].sum(-1).mean(1),
             "b": out["bias"].mean(1)}, weights.LAST_SS_PATH)


class OracleConfig(NamedTuple):
    """One oracle config of tests/test_numpy_parity.py (file:line in
    `source`): the planted model's and the fitted model's constructor
    arguments (the port's classes), the oracle's, the chain lengths, the
    seeds of each side's chains there, and the tolerances on the pooled
    posterior means. The oracle reads sigma_b as the bias prior's variance
    (the models' sigma_bias is its standard deviation) and gets its
    square, so both sample the same posterior."""
    source: str
    N: int
    T: int
    planted: dict            # NonlinearAutoregressiveModel kwargs + seed
    model: dict              # NonlinearAutoregressiveModel kwargs
    oracle: dict             # NumpyGLMReference kwargs
    burn: int
    keep: int
    port_seeds: tuple
    oracle_seeds: tuple
    tol: dict                # metric -> bound (config_compare's names)


def _er_net(rho, sigma_w, mu_b, sigma_b):
    return dict(rho_init=rho, learn_rho=False, mu_bias=mu_b,
                sigma_bias=sigma_b, learn_weight_prior=False,
                sigma_w=sigma_w)


_SBM_NET = dict(K=2, a_rho=1.0, b_rho=1.0, alpha_pi=1.0, sigma_w=0.5,
                niw_kappa0=1.0, niw_psi0=1.0, mu_bias=-1.0, sigma_bias=0.4,
                rho_init=0.35)
_LD_NET = dict(dim=2, sigma_l=1.0, sigma_gamma=2.0, sigma_w=0.5,
               mu_bias=-1.0, sigma_bias=0.4, niw_kappa0=1.0, niw_psi0=1.0)
_MEANS = {"b": 0.25, "A": 0.22, "W": 0.35, "density": 0.06}
ORACLE_CONFIGS = {
    "dense_niw": OracleConfig(
        "tests/test_numpy_parity.py:560", N=4, T=1500,
        planted=dict(seed=31, network="dense", net_kwargs=dict(
            learn_weight_prior=False, sigma_w=0.05, mu_bias=-1.0,
            sigma_bias=0.4)),
        model=dict(network="dense", net_kwargs=dict(
            mu_bias=-1.0, sigma_bias=0.4, sigma_w=0.05, niw_kappa0=1.0,
            niw_psi0=1.0)),
        oracle=dict(network="dense", sigma_w=0.05, mu_b=-1.0,
                    sigma_b=0.4 ** 2, niw_kappa0=1.0, niw_psi0=1.0),
        burn=150, keep=400, port_seeds=(0,), oracle_seeds=(7,),
        tol={"b": 0.25, "W": 0.25, "mu": 0.15, "trSigma_rel": 0.3}),
    "gaussian": OracleConfig(
        "tests/test_numpy_parity.py:132", N=5, T=2000,
        planted=dict(seed=456, observation="gaussian",
                     network="erdos_renyi", spike_and_slab=True,
                     obs_kwargs=dict(eta_init=0.3, resample_eta=False),
                     net_kwargs=_er_net(0.35, 0.05, 0.3, 0.4)),
        model=dict(observation="gaussian", network="erdos_renyi",
                   spike_and_slab=True,
                   obs_kwargs=dict(eta_init=1.0, a_eta=2.0, b_eta=1.0),
                   net_kwargs=_er_net(0.35, 0.05, 0.3, 0.4)),
        oracle=dict(rho=0.35, mu_w=0.0, sigma_w=0.05, mu_b=0.3,
                    sigma_b=0.4 ** 2, observation="gaussian", eta_init=1.0,
                    a_eta=2.0, b_eta=1.0),
        burn=200, keep=800, port_seeds=(0, 1), oracle_seeds=(7, 8),
        tol={"b": 0.08, "W": 0.08, "density": 0.04, "A": 0.25,
             "eta_rel": 0.05}),
    "binomial": OracleConfig(
        "tests/test_numpy_parity.py:218", N=5, T=1000,
        planted=dict(seed=77, observation="binomial",
                     network="erdos_renyi", spike_and_slab=True,
                     obs_kwargs=dict(n_trials=3),
                     net_kwargs=_er_net(0.35, 0.05, -1.5, 0.3)),
        model=dict(observation="binomial", network="erdos_renyi",
                   spike_and_slab=True, obs_kwargs=dict(n_trials=3),
                   net_kwargs=_er_net(0.35, 0.05, -1.5, 0.3)),
        oracle=dict(rho=0.35, mu_w=0.0, sigma_w=0.05, mu_b=-1.5,
                    sigma_b=0.3 ** 2, observation="binomial", n_trials=3),
        burn=150, keep=400, port_seeds=(0, 1), oracle_seeds=(7, 8),
        tol={"b": 0.2, "W": 0.2, "A": 0.3, "density": 0.06}),
    "sbm": OracleConfig(
        "tests/test_numpy_parity.py:313", N=6, T=1500,
        planted=dict(seed=99, network="sbm", spike_and_slab=True,
                     net_kwargs=_SBM_NET),
        model=dict(network="sbm", spike_and_slab=True, net_kwargs=_SBM_NET),
        oracle=dict(rho=0.35, sigma_w=0.5, mu_b=-1.0, sigma_b=0.4 ** 2,
                    network="sbm", K=2, alpha_pi=1.0, a_rho=1.0, b_rho=1.0,
                    niw_kappa0=1.0, niw_psi0=1.0),
        burn=200, keep=600, port_seeds=(0, 1), oracle_seeds=(7, 8),
        tol={**_MEANS, "A": 0.25, "rho_mean": 0.12}),
    "latent_distance": OracleConfig(
        "tests/test_numpy_parity.py:405", N=5, T=1500,
        planted=dict(seed=11, network="latent_distance",
                     spike_and_slab=True,
                     net_kwargs=dict(_LD_NET, gamma_init=0.5)),
        model=dict(network="latent_distance", spike_and_slab=True,
                   net_kwargs=dict(_LD_NET, swap_moves=2, relocate_moves=2)),
        oracle=dict(rho=0.35, sigma_w=0.5, mu_b=-1.0, sigma_b=0.4 ** 2,
                    network="latent_distance", dim=2, sigma_l=1.0,
                    sigma_gamma=2.0, niw_kappa0=1.0, niw_psi0=1.0),
        burn=200, keep=600, port_seeds=(0, 1), oracle_seeds=(7, 8),
        tol={**_MEANS, "A": 0.25, "gamma": 0.6}),
}
CFG_B, CFG_L = 2, 4


def _extras(name, net, aux):
    """A config's functionals beyond (A, W_effective, b) of one state (or
    a stacked one, chain axis first), as (chains, ...) arrays."""
    if name == "dense_niw":
        return {"mu": net.mu,
                "trSigma": net.Sigma.diagonal(dim1=-2, dim2=-1).sum(-1)}
    if name == "gaussian":
        return {"eta": aux["eta"]}
    if name == "sbm":
        return {"rho_mean": net.rho.mean((-2, -1))}
    if name == "latent_distance":
        return {"gamma": net.gamma}
    return {}


def config_data(name: str, device="cpu"):
    """The config's planted data (T, N), by the port's generator."""
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.ops.basis import cosine_basis
    cfg = ORACLE_CONFIGS[name]
    return NonlinearAutoregressiveModel(
        cfg.N, basis=cosine_basis(CFG_B, CFG_L), device=device,
        **cfg.planted).generate(cfg.T, keep=False)


def config_port_means(name: str, Y, seeds, device="cpu", stacked=True,
                      precision="high", sweeps=None):
    """The port's chains on Y at the config's priors and lengths (or
    `sweeps` = (burn, keep)): {functional: (chains, ...) posterior means}
    with "A", "W" (W_effective), "b" and the config's extras. `stacked`
    runs the chains of `seeds` as one lane-stacked sweep (ensemble seeds);
    else one model per seed, seeded so, on its own sweep (the Gaussian
    family's cached Grams included)."""
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models.ensemble import (
        _SWEEP_SALT, chain_generators, ensemble_generators,
        make_stacked_sweep, stack_states,
    )
    from pyglm_tpu_torch.models.sweep import init_state_from_prior
    from pyglm_tpu_torch.ops.basis import cosine_basis
    cfg = ORACLE_CONFIGS[name]
    burn, keep = sweeps or (cfg.burn, cfg.keep)

    def model(seed):
        m = NonlinearAutoregressiveModel(
            cfg.N, basis=cosine_basis(CFG_B, CFG_L), seed=seed,
            precision=precision, device=device, **cfg.model)
        m.add_data(Y)
        return m

    def run(sweep, gens, st, datas, single):
        acc = {}
        for it in range(burn + keep):
            st, _ = sweep(gens, st, datas)
            if it < burn:
                continue
            A = st.A[None] if single else st.A
            W = (st.A[..., None] * st.W).sum(-1)
            vals = {"A": A, "W": W[None] if single else W,
                    "b": st.b[None] if single else st.b}
            for k, v in _extras(name, st.net, st.aux).items():
                vals[k] = v[None] if single else v
            for k, v in vals.items():
                acc[k] = acc.get(k, 0.0) + v.double().cpu() / keep
        return {k: v.numpy() for k, v in acc.items()}

    if not stacked:
        outs = []
        for sd in seeds:
            m = model(sd)
            outs.append(run(m._sweep, m.generators, m.state,
                            tuple(m.datas), True))
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    m = model(0)
    dev = m.device
    st = stack_states([init_state_from_prior(
        ensemble_generators(sd, dev), m.observation, m.network, m.N, m.B,
        m.spike_and_slab, dev) for sd in seeds])
    sweep = make_stacked_sweep(m.observation, m.network, m.N, m.B,
                               len(seeds), m.spike_and_slab, group=m.group,
                               precision=precision)
    return run(sweep, chain_generators(int(seeds[0]) + _SWEEP_SALT, dev),
               st, tuple(m.datas), False)


def config_oracle_means(name: str, Y, seed: int, sweeps=None):
    """One oracle chain on Y at the config's priors and lengths: the
    posterior means as config_port_means gives them (chain axis of 1), and
    its seconds."""
    from pyglm_tpu_torch.ops.basis import cosine_basis
    from pyglm_tpu_torch.reference.numpy_ref import NumpyGLMReference
    cfg = ORACLE_CONFIGS[name]
    burn, keep = sweeps or (cfg.burn, cfg.keep)
    Y = np.asarray(Y, np.float64)
    ref = NumpyGLMReference(
        N=cfg.N, B=CFG_B,
        basis=np.asarray(cosine_basis(CFG_B, CFG_L), np.float64), seed=seed,
        **cfg.oracle)
    Xf = ref.design(Y)
    t0 = time.perf_counter()
    acc = {}
    for it in range(burn + keep):
        ref.resample(Y, Xf)
        if it < burn:
            continue
        vals = {"A": ref.A, "W": (ref.A[:, :, None] * ref.W).sum(-1),
                "b": ref.b}
        if name == "dense_niw":
            vals.update(mu=ref.mu_sh, trSigma=np.trace(ref.Sigma_sh))
        elif name == "gaussian":
            vals["eta"] = ref.eta
        elif name == "sbm":
            vals["rho_mean"] = ref.rho_blk.mean()
        elif name == "latent_distance":
            vals["gamma"] = ref.gamma
        for k, v in vals.items():
            acc[k] = acc.get(k, 0.0) + np.asarray(v, np.float64) / keep
    return ({k: v[None] for k, v in acc.items()},
            time.perf_counter() - t0)


def config_compare(name: str, port: dict, oracle: dict) -> dict:
    """The config's numbers for two pools of per-chain means: the max
    differences of the pooled means (bias, edge marginals, W_effective,
    the mean edge probability; and the extras: the learned prior's mean,
    its trace relative, eta relative, the mean block rho, gamma), and the
    max per-edge |z| of the edge marginals as :func:`pool_compare` reads
    it (0 where A is all ones, as under the dense prior)."""
    cfg = ORACLE_CONFIGS[name]
    m1 = {k: v.mean(0) for k, v in port.items()}
    m2 = {k: v.mean(0) for k, v in oracle.items()}
    out = {"b": float(np.abs(m1["b"] - m2["b"]).max()),
           "W": float(np.abs(m1["W"] - m2["W"]).max()),
           "A": float(np.abs(m1["A"] - m2["A"]).max()),
           "density": float(abs(m1["A"].mean() - m2["A"].mean()))}
    if "mu" in m1:
        out["mu"] = float(np.abs(m1["mu"] - m2["mu"]).max())
        out["trSigma_rel"] = float(abs(m1["trSigma"] - m2["trSigma"])
                                   / m2["trSigma"])
    if "eta" in m1:
        out["eta_rel"] = float(np.abs((m1["eta"] - m2["eta"])
                                      / m2["eta"]).max())
    for k in ("rho_mean", "gamma"):
        if k in m1:
            out[k] = float(abs(m1[k] - m2[k]))
    c1, c2 = len(port["A"]), len(oracle["A"])
    se = np.sqrt((port["A"].var(0, ddof=1) / c1 if c1 > 1 else 0.0)
                 + (oracle["A"].var(0, ddof=1) / c2 if c2 > 1 else 0.0)
                 + (1.0 / (min(c1, c2) * cfg.keep)) ** 2)
    out["max_z"] = float((np.abs(m1["A"] - m2["A"]) / se).max())
    return out


def config_parity(name: str, sweeps=None, n_chains=None, stacked=False):
    """A config on the CPU as tests/test_numpy_parity.py runs it: the
    planted data, the port's single chains on the config's seeds (one
    lane-stacked sweep if `stacked`) and as many oracle chains (the first
    `n_chains` of each side's seeds if given), at `sweeps` = (burn, keep)
    or the config's lengths. (config_compare's numbers, the port's pool of
    means)."""
    cfg = ORACLE_CONFIGS[name]
    n = n_chains or len(cfg.port_seeds)
    Y = config_data(name)
    port = config_port_means(name, Y, cfg.port_seeds[:n], stacked=stacked,
                             sweeps=sweeps)
    orc = [config_oracle_means(name, Y, sd, sweeps=sweeps)[0]
           for sd in cfg.oracle_seeds[:n]]
    return config_compare(name, port, {k: np.concatenate([o[k] for o in orc])
                                       for k in orc[0]}), port


def config_gates(name: str, r: dict, z_max: float | None = None) -> bool:
    """config_compare's numbers within the config's tolerances (and, with
    `z_max`, every edge marginal within z_max standard errors)."""
    ok = all(r[k] < tol for k, tol in ORACLE_CONFIGS[name].tol.items())
    return ok and (z_max is None or r["max_z"] < z_max)


def tempered_pool(Y, s0: int, betas=TEMPER_BETAS, n_ladders: int = PAR_C,
                  precision: str = "high", device="cuda"):
    """The cold rungs of `n_ladders` tempering ladders (`betas`, ending at
    1) at the pools' protocol, run as one tempered pass of n_ladders * C
    rungs (``models/tempering.py``): the betas tiled over the ladders, the
    swaps drawn per ladder by ``swap_permutation`` on the host generator,
    each ladder's permutation applied to its own rungs. Rung c of ladder l
    starts from ``ensemble_generators(s0 + l C + c)``. Returns (the cold
    rungs' posterior means {"A", "W" (W_effective): (n_ladders, N, N),
    "b": (n_ladders, N)} over PAR_KEEP sweeps after PAR_BURN, the swap
    rates per rung (C,) over all ladders and sweeps, the loop that ran).
    A harness of this module: the model API tempers one ladder."""
    import torch
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import tempering as tm
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops.basis import cosine_basis
    m = SparseBernoulliGLM(PAR_N, basis=cosine_basis(PAR_B, PAR_L), seed=0,
                           net_kwargs=PAR_NET, precision=precision,
                           device=device)
    m.add_data(Y)
    betas = np.asarray(betas, np.float64)
    C = betas.shape[0]
    R = n_ladders * C
    tiled = np.tile(betas, n_ladders)
    gibbs = tm._make_tempered_pass(m.observation, m.network, PAR_N, PAR_B,
                                   torch.tensor(tiled), True, group=m.group,
                                   precision=precision)
    seeds = list(range(s0, s0 + R))
    st = tm.init_tempered_states(m, tiled, seeds)
    gens = tm.tempered_generators(seeds, m.device)
    datas = tuple(m.datas)
    cold = torch.arange(n_ladders, device=m.device) * C + C - 1
    offset = torch.arange(n_ladders).repeat_interleave(C) * C
    sums = {k: 0.0 for k in "AWb"}
    acc, n_par1 = np.zeros(C), 0
    for it in range(PAR_BURN + PAR_KEEP):
        st, d = gibbs(gens, st, datas)
        lls = d["log_likelihood"].cpu().reshape(n_ladders, C)
        perms = []
        for l in range(n_ladders):
            p, a, parity = tm.swap_permutation(gens.host, lls[l], betas)
            perms.append(p)
            acc += a.numpy()
            n_par1 += parity
        st = tm.permute_states(st, torch.cat(perms) + offset)
        if it >= PAR_BURN:
            sums["A"] = sums["A"] + st.A[cold]
            sums["W"] = sums["W"] + st.W[cold].sum(-1)
            sums["b"] = sums["b"] + st.b[cold]
    pool = {k: (v / PAR_KEEP).cpu().numpy() for k, v in sums.items()}
    rates = tm.swap_rates(acc, n_ladders * (PAR_BURN + PAR_KEEP), n_par1)
    return pool, rates, weights.LAST_SS_PATH


def perm_band(a, b, seed: int = 0) -> float:
    """The chain-parity band of two pools of chains a, b (C, N, N): the
    PAR_PERM_Q quantile of the max edge-marginal difference over PAR_PERM
    random splits of their chains into pools of the same sizes, capped at
    PAR_BAND_CAP."""
    x = np.concatenate([a, b]).reshape(len(a) + len(b), -1)
    rng = np.random.default_rng(seed)
    stats = []
    for _ in range(PAR_PERM // 1000):
        idx = np.argsort(rng.random((1000, len(x))), axis=1)
        stats.append(np.abs(x[idx[:, :len(a)]].mean(1)
                            - x[idx[:, len(a):]].mean(1)).max(1))
    return min(PAR_BAND_CAP,
               float(np.quantile(np.concatenate(stats), PAR_PERM_Q)))


def pool_compare(p1, p2, n_keep: int = PAR_KEEP) -> dict:
    """The oracle protocol's numbers for two pools of per-chain means
    {"A", "W": (C, N, N), "b": (C, N)}, and the max per-edge |z| of the
    edge marginals on the pools' combined standard error (from the spread
    of their chains, floored at one kept sweep of one chain of the smaller
    pool: edges that no chain ever flips)."""
    m1 = {k: v.mean(0) for k, v in p1.items()}
    m2 = {k: v.mean(0) for k, v in p2.items()}
    c1, c2 = p1["A"].shape[0], p2["A"].shape[0]
    d = np.abs(m1["A"] - m2["A"])
    se = np.sqrt(p1["A"].var(0, ddof=1) / c1 + p2["A"].var(0, ddof=1) / c2
                 + (1.0 / (min(c1, c2) * n_keep)) ** 2)
    return {"max_edge_marginal_diff": float(d.max()),
            "max_weight_mean_diff": float(np.abs(m1["W"] - m2["W"]).max()),
            "max_bias_mean_diff": float(np.abs(m1["b"] - m2["b"]).max()),
            "mean_edge_prob_diff": float(abs(m1["A"].mean()
                                             - m2["A"].mean())),
            "max_z": float((d / se).max())}


def oracle_gates(r: dict) -> bool:
    """pool_compare's numbers within the oracle protocol's tolerances and
    every edge within ORC_Z standard errors."""
    return (all(r[k] < tol for k, tol in ORC_TOL.items())
            and r["max_z"] < ORC_Z)


def parity_gates(p1, p2) -> tuple[bool, dict]:
    """The chain-parity gates of pool p1 against pool p2: the max
    edge-marginal difference within perm_band and every edge within PAR_Z
    standard errors. (verdict, numbers)."""
    r = pool_compare(p1, p2)
    r["band"] = perm_band(p1["A"], p2["A"])
    return (r["max_edge_marginal_diff"] <= r["band"]
            and r["max_z"] < PAR_Z), r


def oracle_chain(Y, seed: int):
    """One oracle chain of PAR_BURN + PAR_KEEP sweeps on Y at the protocol's
    priors: its posterior means of A, W_effective and the bias, and its
    seconds. The oracle's sigma_b is the bias prior's variance and the
    models' sigma_bias its standard deviation (sigma_w is a variance in
    both), so the oracle takes sigma_bias squared: the same posterior.
    (tests/test_numpy_parity.py passes 0.4 to both, which gives the oracle
    a bias prior 2.5 times as wide.)"""
    from pyglm_tpu_torch.ops.basis import cosine_basis
    from pyglm_tpu_torch.reference.numpy_ref import NumpyGLMReference
    ref = NumpyGLMReference(
        N=PAR_N, B=PAR_B,
        basis=np.asarray(cosine_basis(PAR_B, PAR_L), np.float64),
        rho=PAR_NET["rho_init"], mu_w=0.0, sigma_w=PAR_NET["sigma_w"],
        mu_b=PAR_NET["mu_bias"], sigma_b=PAR_NET["sigma_bias"] ** 2,
        seed=seed)
    t0 = time.perf_counter()
    A, W, b = posterior_means(ref, Y, PAR_BURN, PAR_KEEP)
    return A, W, b, time.perf_counter() - t0


def start_oracle(Y, seeds, processes: int):
    """Start oracle chains on `seeds` in a pool of `processes` spawned
    processes, each with one BLAS thread: (pool, pending result). Join the
    pool after the result, or terminate it."""
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update({k: "1" for k in _ONE_THREAD})
    try:
        pool = mp.get_context("spawn").Pool(processes)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    res = pool.starmap_async(oracle_chain,
                             [(np.asarray(Y), s) for s in seeds])
    pool.close()
    return pool, res


def stack_chains(res) -> dict:
    """oracle_chain results -> a pool {"A", "W", "b"} of per-chain means."""
    return {k: np.stack([r[i] for r in res]) for i, k in enumerate("AWb")}


def _subpool(pool, idx):
    return {k: v[idx] for k, v in pool.items()}


def null_study(n_high: int, n_default: int, n_sr: int, n_oracle: int,
               procs: int, draws: int = 2000):
    """The gates where no mode is biased (see the module docstring):
    (the port's pools, the oracle's pool of all its chains, the
    readings)."""
    Y = parity_data()
    bases = {"high": [1, 101] + [401 + 100 * i for i in range(n_high - 2)]}
    nxt = 401 + 100 * max(n_high - 2, 0)
    bases["default"] = [201] + [nxt + 100 * i for i in range(n_default - 1)]
    nxt += 100 * max(n_default - 1, 0)
    bases["sr"] = [301] + [nxt + 100 * i for i in range(n_sr - 1)]
    orc_pool, pending = start_oracle(Y, range(7, 7 + n_oracle), procs)
    try:
        t0 = time.perf_counter()
        pools = {f"{p}{s}": parity_pool(Y, p, s)[0]
                 for p, ss in bases.items() for s in ss}
        pool_s = time.perf_counter() - t0
        res = pending.get(timeout=3000)
        orc_pool.join()
    except BaseException:
        orc_pool.terminate()
        raise
    orc = stack_chains(res)
    highs = [f"high{s}" for s in bases["high"]]
    pairs = {}
    for a, b in itertools.combinations(highs, 2):
        ok, r = parity_gates(pools[a], pools[b])
        pairs[f"{a}-{b}"] = dict(r, ok=ok)
    orc_pools = [_subpool(orc, slice(i, i + ORC_C))
                 for i in range(0, n_oracle - ORC_C + 1, ORC_C)]
    vs_oracle = {}
    for k, p in pools.items():
        rs = [pool_compare(p, o) for o in orc_pools]
        vs_oracle[k] = {"ok": [oracle_gates(r) for r in rs],
                        "max_edge_marginal_diff": [
                            r["max_edge_marginal_diff"] for r in rs],
                        "max_weight_mean_diff": [
                            r["max_weight_mean_diff"] for r in rs],
                        "max_z": [r["max_z"] for r in rs]}
    # False-failure rates over random disjoint draws from all the chains.
    allh = {k: np.concatenate([pools[h][k] for h in highs]) for k in "AWb"}
    rng = np.random.default_rng(1)
    n_h = len(allh["A"])
    par_fail = {"over_cap": 0, "z": 0}
    orc_fail = {k: 0 for k in (*ORC_TOL, "max_z", "any")}
    for _ in range(draws):
        i = rng.permutation(n_h)
        p1, p2 = _subpool(allh, i[:PAR_C]), _subpool(allh, i[PAR_C:2 * PAR_C])
        r = pool_compare(p1, p2)
        par_fail["over_cap"] += r["max_edge_marginal_diff"] > PAR_BAND_CAP
        par_fail["z"] += r["max_z"] >= PAR_Z
        r = pool_compare(p1, _subpool(orc, rng.permutation(n_oracle)[:ORC_C]))
        for k, tol in ORC_TOL.items():
            orc_fail[k] += r[k] >= tol
        orc_fail["max_z"] += r["max_z"] >= ORC_Z
        orc_fail["any"] += not oracle_gates(r)
    return pools, orc, {
        "par_c": PAR_C, "orc_c": ORC_C, "pool_s": pool_s,
        "pool_s_each": pool_s / len(pools),
        "oracle_chain_s": [r[3] for r in res],
        "high_pairs": pairs,
        "high_pairs_failed": sum(not v["ok"] for v in pairs.values()),
        "n_high_pairs": len(pairs),
        "vs_high1": {k: parity_gates(pools[k], pools["high1"])[1]
                     for k in pools if k != "high1"},
        "vs_oracle": vs_oracle,
        "vs_oracle_failed": sum(not ok for v in vs_oracle.values()
                                for ok in v["ok"]),
        "n_vs_oracle": sum(len(v["ok"]) for v in vs_oracle.values()),
        "draws": draws,
        "parity_fail_rate": {k: v / draws for k, v in par_fail.items()},
        "oracle_fail_rate": {k: v / draws for k, v in orc_fail.items()},
    }


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--high", type=int, default=8)
    ap.add_argument("--default", type=int, default=2)
    ap.add_argument("--sr", type=int, default=2)
    ap.add_argument("--oracle", type=int, default=128)
    ap.add_argument("--procs", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    pools, orc, out = null_study(a.high, a.default, a.sr, a.oracle, a.procs)
    out["card"] = card
    if a.out:
        with open(a.out, "w") as f:
            f.write(json.dumps(out) + "\n")
        np.savez(os.path.splitext(a.out)[0] + ".npz", **{
            f"{name}_{k}": v for name, p in (*pools.items(), ("oracle", orc))
            for k, v in p.items()})
    print(card)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("high_pairs", "vs_high1", "vs_oracle")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
