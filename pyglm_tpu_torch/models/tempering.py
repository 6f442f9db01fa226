"""Parallel tempering on the lane-stacked ensemble (PyTorch counterpart of
``pyglm_tpu/models/tempering.py``).

A ladder beta_1 < ... < beta_C = 1 runs as ONE lane-stacked sweep
(models/ensemble.py): chain c sweeps the power posterior
p(theta) L(theta)^{beta_c}, which stays PG-conjugate for every family here
(the PG shape and kappa scale by beta, the Gaussian precision by beta; see
models/observations.py ``tempered_omega_kappa``). Likelihood-side
auxiliaries (NB r, Gaussian eta) must be fixed (``tempering_blocker``).
Rung C-1 (beta = 1) is the exact cold chain. Between sweeps, adjacent
rungs exchange their whole state (A, W, b, aux and the network state) by
a Metropolis swap on the ladder's joint density, accepted with probability

    min(1, exp((beta_j - beta_i) (ll_i - ll_j))),

ll the untempered data log-likelihood. Even or odd adjacent pairs, by a
random parity bit, attempt a swap each sweep. The swap reads the (C,)
log-likelihoods on the host (one transfer a sweep) and permutes the state
with ``index_select`` where each field lives.

Adjacent acceptance is roughly Phi(-|d beta| sd(ll)), so a ladder whose
gap is well above 1 / sd(ll) freezes; :func:`suggest_ladder` sizes the gap
from a measured sd(ll).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from pyglm_tpu_torch.diagnostics.profiling import span, wait
from pyglm_tpu_torch.models.ensemble import (
    chain_generators, ensemble_generators, make_stacked_sweep, stack_states,
)
from pyglm_tpu_torch.models.sweep import init_state_from_prior

# The tempered sweep's generators: chain_generators(seeds[0] + this salt),
# other streams than the ensemble sweep's (ensemble._SWEEP_SALT).
_TEMPER_SALT = 0x7E3B


def swap_permutation(generator: torch.Generator, lls, betas, parity=None,
                     uniforms=None):
    """One even/odd round of adjacent-rung Metropolis swaps.

    Args:
      generator: a CPU generator; draws the parity bit, then C uniforms
        (one per pair is read, at the pair's lower index), unless given.
      lls: (C,) untempered data log-likelihood of each rung's state.
      betas: (C,) ascending inverse temperatures.
      parity: 0 or 1, the pairs' parity (default: a fair bit drawn).
      uniforms: (C,) uniforms in [0, 1) (default: drawn).
    Returns (perm (C,) int64 host tensor, to apply as x[perm] to every
    field of the stacked state; accept (C,) float32, 1 where the rung
    swapped; parity, an int).
    """
    lls = torch.as_tensor(lls, dtype=torch.float32).cpu()
    betas = torch.as_tensor(betas, dtype=torch.float32).cpu()
    C = betas.shape[0]
    if parity is None:
        parity = int(torch.randint(0, 2, (), generator=generator))
    if uniforms is None:
        uniforms = torch.rand((C,), generator=generator)
    uniforms = torch.as_tensor(uniforms, dtype=torch.float32).cpu()
    i = torch.arange(C)
    is_left = ((i - int(parity)) % 2) == 0
    partner = torch.where(is_left, i + 1, i - 1)
    valid = (partner >= 0) & (partner < C)
    partner = partner.clamp(0, C - 1)
    # Symmetric under i <-> partner: both members of a pair agree.
    log_alpha = (betas[partner] - betas[i]) * (lls[i] - lls[partner])
    u_pair = uniforms[torch.minimum(i, partner)]
    accept = valid & (torch.log(u_pair) < log_alpha)
    perm = torch.where(accept, partner, i)
    return perm, accept.to(torch.float32), int(parity)


def suggest_ladder(sd_ll, C, accept=0.3, beta_max=1.0, beta_floor=0.05):
    """Uniform-gap ladder whose adjacent swaps accept at about `accept`,
    given the posterior standard deviation of the untempered
    log-likelihood: adjacent acceptance ~ erfc(d beta sd_ll / 2), inverted
    for d beta. Returns (betas (C,) float64, feasible span d beta (C-1)).

    Where sd_ll is small the gap would push beta_1 to zero or below (PG(0,
    psi) gives omega = 0, and psi's recovery divides by it): the ladder is
    then clamped to [beta_floor, beta_max], with a warning; adjacent
    acceptance comes out higher than asked, which is harmless."""
    from scipy.special import erfcinv
    dbeta = 2.0 * erfcinv(accept) / max(float(sd_ll), 1e-12)
    if dbeta * (C - 1) > beta_max - beta_floor:
        dbeta_c = (beta_max - beta_floor) / max(C - 1, 1)
        warnings.warn(
            f"suggest_ladder: the acceptance-targeted rung gap "
            f"dbeta={dbeta:.4g} would drive beta_1 to "
            f"{beta_max - dbeta * (C - 1):.4g} <= 0-ish at C={C}; "
            f"clamping the ladder to [{beta_floor}, {beta_max}] "
            f"(gap {dbeta_c:.4g}, adjacent acceptance above the requested "
            f"{accept})", stacklevel=2)
        dbeta = dbeta_c
    betas = beta_max - dbeta * np.arange(C - 1, -1, -1)
    return np.asarray(betas, np.float64), float(dbeta * (C - 1))


def permute_states(st, perm):
    """Every tensor of a stacked state (nested in tuples and dicts) with
    its chain axis permuted: x.index_select(0, perm) where x lives."""
    if st is None:
        return None
    if isinstance(st, dict):
        return {k: permute_states(v, perm) for k, v in st.items()}
    if isinstance(st, tuple):
        return type(st)(*(permute_states(f, perm) for f in st))
    if st.device != perm.device:
        with wait("perm"):
            perm = perm.to(st.device)
    return st.index_select(0, perm)


def _check_tempering(obs):
    blocker = obs.tempering_blocker()
    if blocker is not None:
        raise ValueError(blocker)


def _make_tempered_pass(obs, network, N: int, B: int, betas,
                        spike_slab: bool, t_chunk: int = 512,
                        group: int | None = None, precision: str = "high"):
    """The within-rung tempered Gibbs pass over the C rungs of `betas`, no
    swaps: (generators, stacked state, datas) -> (stacked state, diag),
    diag's "log_likelihood" (C,) untempered. It is the lane-stacked sweep
    at `betas` (``make_stacked_sweep``)."""
    _check_tempering(obs)
    return make_stacked_sweep(obs, network, N, B, len(betas), spike_slab,
                              t_chunk, group=group, precision=precision,
                              betas=betas)


def make_tempered_sweep(obs, network, N: int, B: int, betas,
                        spike_slab: bool = True, t_chunk: int = 512,
                        group: int | None = None, precision: str = "high"):
    """The C-rung parallel-tempering sweep: (generators, stacked state,
    datas) -> (stacked state, diag). Rung c targets the beta_c-power
    posterior; rung C-1 (beta = 1) is the cold chain. diag:
    "log_likelihood" (C,) of the states after the swap (host),
    "n_edges" (C,) before it, "swap_accept" (C,), "swap_parity" (an int),
    and "hmc_accept" (C,) for the latent-distance prior. Raises ValueError
    for a family that cannot temper (``tempering_blocker``). The sweep is
    one step span "tempered_sweep" (``diagnostics.profiling``) around the
    stacked sweep's stages and the "swap". `t_chunk`
    reaches only the dense update's fp32 partial sums
    (:func:`models.weights.sufficient_stats`), as in the JAX package it
    reaches only the XLA paths; the kernels keep their own splits of T."""
    betas_h = torch.as_tensor(np.asarray(betas, np.float32))
    gibbs = _make_tempered_pass(obs, network, N, B, betas_h, spike_slab,
                                t_chunk, group=group, precision=precision)

    def sweep(gens, st, datas):
        with span("tempered_sweep", step=True):
            st, d = gibbs(gens, st, datas)
            with span("swap"):
                with wait("lls"):
                    lls = d["log_likelihood"].cpu()   # one transfer a sweep
                perm, accept, parity = swap_permutation(gens.host, lls,
                                                        betas_h)
                st = permute_states(st, perm)
        return st, _swap_diag(st, lls, perm, accept, parity,
                              d["n_edges"])

    return sweep


def swap_rates(accepts, n_sweeps: int, n_parity1: int):
    """Accepted swaps per attempt (C,) of a ladder from its summed
    ``swap_accept`` over `n_sweeps` sweeps, `n_parity1` of them at parity
    1. Interior rungs attempt a swap every sweep; rung 0 pairs rightward
    at parity 0; rung C-1 leftward at parity 0 when C is even, at parity 1
    when C is odd (:func:`swap_permutation`'s pairing). The end rungs'
    attempts count the parity bits actually drawn."""
    accepts = np.asarray(accepts, np.float64)
    C, n0 = accepts.shape[0], n_sweeps - n_parity1
    attempts = np.full(C, max(n_sweeps, 1), np.float64)
    attempts[0] = max(n0, 1)
    attempts[-1] = max(n0 if C % 2 == 0 else n_parity1, 1)
    return accepts / attempts


def _swap_diag(st, lls, perm, accept, parity, n_edges):
    diag = {"log_likelihood": lls[perm], "n_edges": n_edges,
            "swap_accept": accept, "swap_parity": parity}
    if hasattr(st.net, "hmc_accept"):
        diag["hmc_accept"] = st.net.hmc_accept
    return diag


def make_tempered_sweep_sharded(obs, network, N: int, B: int, betas, mesh,
                                spike_slab: bool = True, t_chunk: int = 512,
                                group: int | None = None,
                                precision: str = "high"):
    """The C-rung tempering sweep with rungs spread over a ("chain",) mesh
    of M ranks: ``sweep(MeshGenerators, local stacked state, datas)``.
    Each rank runs the tempered pass of its C/M rungs on the whole data
    from its shard generators (kernel K4 at (T, C/M N)); the (C,)
    untempered log-likelihoods are gathered over "chain"; every rank draws
    the same swap from the replicated host generator; the rung states are
    gathered, permuted (:func:`permute_states`) and each rank keeps its
    slice. diag as :func:`make_tempered_sweep`'s, plus "full_state", the
    permuted stack of all C rungs. ValueError unless M divides C."""
    from pyglm_tpu_torch.models.ensemble import make_stacked_sweep_sharded
    from pyglm_tpu_torch.parallel.sharding import (
        CHAIN_AXES, all_gather, gather_tree, require_mesh)
    require_mesh(mesh, CHAIN_AXES)
    _check_tempering(obs)
    betas_h = torch.as_tensor(np.asarray(betas, np.float32))
    C = betas_h.shape[0]
    gibbs = make_stacked_sweep_sharded(obs, network, N, B, C, mesh,
                                       spike_slab, t_chunk, group=group,
                                       precision=precision, betas=betas_h)
    Cl = C // mesh.shape["chain"]
    mine = torch.arange(mesh.index("chain") * Cl,
                        (mesh.index("chain") + 1) * Cl)

    def sweep(gens, st, datas):
        st, d = gibbs(gens.shard, st, datas)
        lls = all_gather(d["log_likelihood"], mesh, "chain").cpu()
        n_edges = all_gather(d["n_edges"], mesh, "chain")
        perm, accept, parity = swap_permutation(gens.replicated.host, lls,
                                                betas_h)
        full = permute_states(gather_tree(st, mesh, "chain"), perm)
        diag = _swap_diag(full, lls, perm, accept, parity, n_edges)
        diag["full_state"] = full
        return permute_states(full, mine), diag

    return sweep


def make_tempered_sweep_gspmd(obs, network, N: int, B: int, betas, mesh,
                              spike_slab: bool = True, t_chunk: int = 512,
                              group: int | None = None,
                              precision: str = "high"):
    """The C-rung tempering sweep on a ("chain", "time", "neuron") mesh:
    the tempered pass is the stacked sweep with the C*N rung lanes sharded
    over ("chain", "neuron") and the sums over "time"
    (``ensemble.make_stacked_sweep_gspmd``); the stacked state is whole on
    every rank, so the swap, drawn on the replicated host generator, moves
    nothing between ranks. ``sweep(MeshGenerators, stacked state, local
    datas)``; diag as :func:`make_tempered_sweep`'s."""
    from pyglm_tpu_torch.models.ensemble import make_stacked_sweep_gspmd
    from pyglm_tpu_torch.parallel.sharding import (CHAIN_DATA_AXES,
                                                   require_mesh)
    require_mesh(mesh, CHAIN_DATA_AXES)
    _check_tempering(obs)
    betas_h = torch.as_tensor(np.asarray(betas, np.float32))
    gibbs = make_stacked_sweep_gspmd(obs, network, N, B, betas_h.shape[0],
                                     mesh, spike_slab, t_chunk, group=group,
                                     precision=precision, betas=betas_h)

    def sweep(gens, st, datas):
        st, d = gibbs(gens, st, datas)
        lls = d["log_likelihood"].cpu()
        perm, accept, parity = swap_permutation(gens.replicated.host, lls,
                                                betas_h)
        st = permute_states(st, perm)
        return st, _swap_diag(st, lls, perm, accept, parity,
                              d["n_edges"])

    return sweep


def tempered_generators(seeds, device):
    """The generators of the tempered sweeps of a ladder seeded `seeds`."""
    return chain_generators(int(seeds[0]) + _TEMPER_SALT, device)


def tempered_mesh_generators(seeds, mesh, device):
    """The MeshGenerators of a tempered sweep on `mesh`: replicated, those
    of :func:`tempered_generators` (the swaps, and on a chain-data mesh the
    pass's replicated draws); shard, the rank's own (on a chain mesh its
    rungs' pass, salted by its chain index)."""
    from pyglm_tpu_torch.models.sweep import MeshGenerators
    from pyglm_tpu_torch.parallel.sharding import shard_generators
    rep = tempered_generators(seeds, device)
    seed = int(seeds[0]) + _TEMPER_SALT
    if "time" in mesh.shape:
        return MeshGenerators(rep, shard_generators(seed, mesh, device))
    return MeshGenerators(rep, chain_generators(
        seed + ((mesh.index("chain") + 1) << 20), device))


def init_tempered_states(model, betas, seeds=None, rungs=None):
    """C prior-initialised rung states stacked on a chain axis, rung c
    drawn from ``ensemble_generators(seeds[c])`` (default seeds 1 .. C), as
    the ensemble seeds its chains: no rung starts from the prior draw of a
    model built with its seed. `rungs` (a slice): only those rungs (a
    chain mesh rank's)."""
    C = len(betas)
    seeds = list(range(1, C + 1) if seeds is None else seeds)
    if len(seeds) != C:
        raise ValueError(f"{len(seeds)} seeds for {C} rungs")
    if rungs is not None:
        seeds = seeds[rungs]
    dev = model.device
    return stack_states([init_state_from_prior(
        ensemble_generators(sd, dev), model.observation, model.network,
        model.N, model.B, model.spike_and_slab, dev) for sd in seeds])
