"""Lane-stacked multi-chain Gibbs: C independent chains as one wide sweep
(PyTorch counterpart of ``pyglm_tpu/models/ensemble.py``).

The Gibbs conditionals factorize over postsyn neurons given the design:
every (T, N) auxiliary array, every (P, N) weight column and the whole
collapsed spike-and-slab update are lane-parallel. C chains of one
N-neuron model are therefore an N_pre-presyn, C*N-postsyn model sharing one
design: stack each chain's postsyn columns side by side (chain-major lanes)
and run the sweep once at C*N lanes. The design, its Gram products and the
PG and edge-scan launches are shared by all C chains. Only the network
prior and the observation's aux couple lanes within a chain; the
latent-distance prior runs its HMC for all chains at once, the others
(dense, Erdos-Renyi, SBM) resample per chain. The dense update forms J over
all C*N lanes in one pass.

Chain c is initialized from the prior with generators seeded from
``seeds[c]`` and salted (:func:`ensemble_generators`), so that it does not
start from the prior draw of a model built with that seed; the stacked
sweeps then draw from one shared stream seeded from ``seeds[0]``, shaped
over the lanes.
"""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import LatentDistanceConfig
from pyglm_tpu_torch.models.sweep import (
    Generators, GLMState, concat_datas, init_state_from_prior,
)
from pyglm_tpu_torch.models.weights import (
    EdgeHypers, pack_weights, resample_dense, resample_spike_slab_tspace,
    sufficient_stats, unpack_weights,
)
from pyglm_tpu_torch.utils.utils import fp32_matmul

_SWEEP_SALT = 0xC8A1


def _to_lanes(x):
    """(C, R, N, ...) -> (R, C*N, ...): chain-major postsyn lanes."""
    C, R, N = x.shape[:3]
    return x.transpose(0, 1).reshape((R, C * N) + tuple(x.shape[3:]))


def _from_lanes(x, C: int):
    """(R, C*N, ...) -> (C, R, N, ...)."""
    R, CN = x.shape[:2]
    return x.reshape((R, C, CN // C) + tuple(x.shape[2:])).transpose(0, 1)


def _stack(xs):
    """Stack one field of C states: tensors, dicts of tensors, NamedTuples
    of tensors, or None."""
    x0 = xs[0]
    if x0 is None:
        return None
    if isinstance(x0, dict):
        return {k: torch.stack([x[k] for x in xs]) for k in x0}
    if isinstance(x0, tuple):
        return type(x0)(*(torch.stack(f) for f in zip(*xs)))
    return torch.stack(xs)


def _index(x, c: int):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v[c] for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(f[c] for f in x))
    return x[c]


def stack_states(states) -> GLMState:
    """C same-config GLMStates -> one GLMState with a leading chain axis
    on every tensor."""
    return GLMState(*(_stack(list(f)) for f in zip(*states)))


def unstack_states(st: GLMState, C: int) -> list:
    return [GLMState(*(_index(f, c) for f in st)) for c in range(C)]


def chain_generators(seed: int, device) -> Generators:
    """A model's generators for `seed` (models/glm.py seeds them so)."""
    dev_gen = torch.Generator(device=device)
    dev_gen.manual_seed(int(seed))
    host_gen = torch.Generator()
    host_gen.manual_seed(int(seed) + 0x5EED)
    return Generators(dev_gen, host_gen)


# A chain seeded sd draws from other streams than a model seeded sd, as the
# JAX package folds 0x5EED into a chain's key: otherwise a chain would start
# from the very prior draw of a model built with its seed, such as the
# truth that simulated the data. (A CPU generator reads the low 32 bits of
# its seed, so the salt lives there.)
_CHAIN_SALT = 0x5EED0000


def ensemble_generators(seed: int, device) -> Generators:
    """The generators of the ensemble chain seeded `seed`."""
    return chain_generators(int(seed) + _CHAIN_SALT, device)


def lane_inputs(network, chains):
    """The packed weights (P, C*N) and the edge priors over the C*N lanes
    of C chain states."""
    dev = chains[0].b.device
    w_lane = _to_lanes(torch.stack([pack_weights(s.A, s.W, s.b)
                                    for s in chains]))
    hyps = [network.edge_hypers(s.net, dev) for s in chains]
    return w_lane, EdgeHypers(
        mu=_to_lanes(torch.stack([h.mu for h in hyps])),
        Lam=_to_lanes(torch.stack([h.Lam for h in hyps])),
        logit_rho=_to_lanes(torch.stack([h.logit_rho for h in hyps])),
        mu_b=torch.cat([h.mu_b for h in hyps]),
        lam_b=torch.cat([h.lam_b for h in hyps]))


def make_stacked_sweep(obs, network, N: int, B: int, C: int,
                       spike_slab: bool, group: int | None = None,
                       precision: str = "highest", betas=None):
    """The C-chain lane-stacked sweep: (generators, stacked state, datas) ->
    (stacked state, diagnostics of shape (C,)): "log_likelihood",
    "n_edges", and "hmc_accept" for the latent-distance prior. The move
    order and conditionals are those of models/sweep.py, per lane and per
    chain, the spike-and-slab update at `precision`, the dense one with J
    over the C*N lanes. The observation's ll cache and the Gaussian's
    cached Grams are not used (as in the JAX package): NB's r update takes
    its elementwise CRT branch, and a Gaussian family forms X' Omega X.

    `betas` (C,), if given, tempers chain c to the beta_c-power posterior
    (models/tempering.py): the family's ``tempered_omega_kappa`` replaces
    ``omega_kappa`` over chain c's lanes, and nothing else changes. The
    "log_likelihood" stays the untempered one, with psi recovered as
    (kappa - u) / omega from the tempered kappa and omega. A family that
    tempers resamples no aux (``tempering_blocker``)."""
    batched_net = isinstance(network, LatentDistanceConfig)
    beta_lane = (None if betas is None else torch.as_tensor(
        betas, dtype=torch.float32).repeat_interleave(N))       # (C*N,)

    @fp32_matmul()
    def sweep(gens: Generators, st: GLMState, datas):
        chains = unstack_states(st, C)
        w_lane, hyp = lane_inputs(network, chains)
        aux_lane = (None if st.aux is None else
                    {k: v.reshape(-1) for k, v in st.aux.items()})
        Y, Xf, Xt = concat_datas(datas)      # datasets concatenate along time
        T = Y.shape[0]
        Y_lane = Y.repeat(1, C)                                   # (T, C*N)

        psi = Xf @ w_lane
        if beta_lane is None:
            omega, kappa = obs.omega_kappa(gens.host, Y_lane, psi, aux_lane)
        else:
            omega, kappa = obs.tempered_omega_kappa(
                gens.host, Y_lane, psi, aux_lane,
                beta_lane.to(psi.device))
        if spike_slab:
            A_lane, w_lane, u, _ = resample_spike_slab_tspace(
                gens.device, Xt, omega, kappa, psi, w_lane, hyp, B,
                group=group, precision=precision, host_generator=gens.host)
            psi = (kappa - u) / omega
            del u
        else:
            J, h = sufficient_stats(Xf, omega, kappa)
            w_lane = resample_dense(gens.device, J, h, hyp, B)
            A_lane = torch.ones((N, C * N), dtype=torch.float32,
                                device=w_lane.device)
            psi = Xf @ w_lane
        del omega, kappa

        w_c = _from_lanes(w_lane, C)                              # (C, P, N)
        W, b = map(torch.stack, zip(*(unpack_weights(w, N, B) for w in w_c)))
        A = _from_lanes(A_lane, C).contiguous()                   # (C, N, N)
        aux_lane = obs.resample_aux(gens.host, aux_lane, Y_lane, psi)
        aux = (None if aux_lane is None else
               {k: v.reshape(C, N) for k, v in aux_lane.items()})
        if batched_net:
            net = network.resample(gens, st.net, A, W)
        else:
            net = _stack([network.resample(gens, s.net, A[c], W[c])
                          for c, s in enumerate(chains)])
        lls = obs.log_likelihood(Y_lane, psi, aux_lane).reshape(
            T, C, N).sum(dim=(0, 2))
        diag = {"log_likelihood": lls, "n_edges": A.sum(dim=(1, 2))}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def run_stacked_chains(model, n_chains: int, n_samples: int,
                       n_burnin: int = 0, thin: int = 1, seeds=None,
                       mesh=None, collect: str = "samples"):
    """Run C prior-initialized chains with the lane-stacked sweep.

    ``collect="samples"``: a list of C per-chain dicts {'A' (S,N,N),
    'W' (S,N,N,B), 'bias' (S,N), 'lls' (S,)}, every ``thin``-th
    post-burn-in sweep. ``collect="mean"``: the post-burn-in sweeps are not
    kept; per-chain means of A and of W_eff = sum_b A W accumulate on the
    device, and the result is one dict {'A_mean' (C,N,N), 'Weff_mean'
    (C,N,N), 'lls' (S,C), 'final_states': list of C GLMState}; every
    post-burn-in sweep counts (``thin`` is ignored), and the means equal
    those of ``collect="samples"`` at thin=1 from the same seeds.
    """
    if mesh is not None:
        raise NotImplementedError(
            "chain meshes are not ported to pyglm_tpu_torch yet (ROADMAP.md "
            "Queue A, item 15)")
    if collect not in ("samples", "mean"):
        raise ValueError(f"collect must be 'samples' or 'mean', got "
                         f"{collect!r}")
    if not model.datas:
        raise RuntimeError("call add_data() or generate(keep=True) first")
    C = n_chains
    seeds = list(range(1, C + 1) if seeds is None else seeds)
    if len(seeds) != C:
        raise ValueError(f"{len(seeds)} seeds for {C} chains")
    dev = model.device
    st = stack_states([init_state_from_prior(
        ensemble_generators(sd, dev), model.observation, model.network,
        model.N, model.B, model.spike_and_slab, dev) for sd in seeds])
    gens = chain_generators(int(seeds[0]) + _SWEEP_SALT, dev)
    sweep = make_stacked_sweep(model.observation, model.network, model.N,
                               model.B, C, model.spike_and_slab,
                               group=model.group, precision=model.precision)
    datas = tuple(model.datas)

    for _ in range(n_burnin):
        st, _ = sweep(gens, st, datas)

    if collect == "mean":
        accA = torch.zeros_like(st.A)
        accW = torch.zeros_like(st.A)
        lls = []
        for _ in range(n_samples):
            st, diag = sweep(gens, st, datas)
            accA += st.A
            accW += st.W.sum(dim=-1)        # W is 0 where A is 0
            lls.append(diag["log_likelihood"])
        return {"A_mean": (accA / n_samples).cpu().numpy(),
                "Weff_mean": (accW / n_samples).cpu().numpy(),
                "lls": (torch.stack(lls).cpu().numpy() if lls
                        else np.zeros((0, C), np.float32)),
                "final_states": unstack_states(st, C)}

    out = {"A": [], "W": [], "bias": [], "lls": []}
    for _ in range(n_samples):
        for _ in range(thin):
            st, diag = sweep(gens, st, datas)
        for k, v in (("A", st.A), ("W", st.W), ("bias", st.b),
                     ("lls", diag["log_likelihood"])):
            out[k].append(v.cpu().numpy())
    N, B = model.N, model.B
    shapes = {"A": (0, C, N, N), "W": (0, C, N, N, B), "bias": (0, C, N),
              "lls": (0, C)}
    stacked = {k: (np.stack(v) if v else np.zeros(shapes[k], np.float32))
               for k, v in out.items()}
    return [{k: stacked[k][:, c] for k in stacked} for c in range(C)]
