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

from pyglm_tpu_torch.diagnostics.profiling import span, wait
from pyglm_tpu_torch.models.networks import LatentDistanceConfig
from pyglm_tpu_torch.models.sweep import (
    Generators, GLMState, MeshGenerators, concat_datas, init_state_from_prior,
)
from pyglm_tpu_torch.models.weights import (
    EdgeHypers, check_t_chunk, lane_hypers, pack_weights, resample_dense,
    resample_spike_slab_tspace, sufficient_stats, unpack_weights,
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
                       spike_slab: bool, t_chunk: int = 512,
                       group: int | None = None, precision: str = "highest",
                       betas=None, mesh=None):
    """The C-chain lane-stacked sweep: (generators, stacked state, datas) ->
    (stacked state, diagnostics of shape (C,)): "log_likelihood",
    "n_edges", and "hmc_accept" for the latent-distance prior. The move
    order and conditionals are those of models/sweep.py, per lane and per
    chain, the spike-and-slab update at `precision`, the dense one with J
    over the C*N lanes. The observation's ll cache and the Gaussian's
    cached Grams are not used (as in the JAX package): NB's r update takes
    its elementwise CRT branch, and a Gaussian family forms X' Omega X.
    `t_chunk` reaches only the dense update's fp32 partial sums
    (:func:`models.weights.sufficient_stats`); the kernels keep their own
    splits of T.

    `betas` (C,), if given, tempers chain c to the beta_c-power posterior
    (models/tempering.py): the family's ``tempered_omega_kappa`` replaces
    ``omega_kappa`` over chain c's lanes, and nothing else changes. The
    "log_likelihood" stays the untempered one, with psi recovered as
    (kappa - u) / omega from the tempered kappa and omega. A family that
    tempers resamples no aux (``tempering_blocker``).

    The sweep is one step span "stacked_sweep" of ``diagnostics.
    profiling`` with the stages of models/sweep.py's: "hypers" (the lane
    packing of the chains' weights, priors and Y), "psi", "pg_draws",
    "weights", "aux", "loglik" and "network".

    With a ("chain", "time", "neuron") `mesh`
    (:func:`make_stacked_sweep_gspmd`) it is one rank's sweep:
    ``sweep(MeshGenerators, stacked state, local datas)``. The stacked
    state is whole on every rank; the C*N lanes shard over ("chain",
    "neuron") and the datas' rows over "time"
    (:func:`chain_data_shardings`). The rank draws the PG variables of its
    (rows, lanes) tile from its shard generators and runs the weight
    update on the mesh (the mesh-fused K2 + K3 loop); the new lanes are
    gathered, and the aux, the network resample and the swaps run
    replicated from the replicated generators.
    """
    t_chunk = check_t_chunk(t_chunk)
    batched_net = isinstance(network, LatentDistanceConfig)
    beta_lane = (None if betas is None else torch.as_tensor(
        betas, dtype=torch.float32).repeat_interleave(N))       # (C*N,)
    on_dev = {}                  # constant index tensors, moved once

    def on(name, x, device):
        if name not in on_dev:
            with wait(name):
                on_dev[name] = x.to(device)
        return on_dev[name]
    if mesh is not None:
        from pyglm_tpu_torch.models.sweep import _concat_rows, mesh_rows
        from pyglm_tpu_torch.models.weights import mesh_ss_path
        from pyglm_tpu_torch.parallel.sharding import (
            all_gather, lane_axes, lane_shard)
        lane_sh = lane_shard(mesh, C * N)
        lanes = lane_sh.lanes
        cols = torch.arange(C * N)[lanes] % N      # each lane's neuron
        LA = lane_axes(mesh)
        if beta_lane is not None:
            beta_lane = beta_lane[lanes]

    @fp32_matmul()
    def sweep(gens, st: GLMState, datas):
        with span("stacked_sweep", step=True):
            return stacked(gens, st, datas)

    def stacked(gens, st: GLMState, datas):
        rep, pg_gen = (gens.replicated, gens.shard.host) if mesh is not None \
            else (gens, gens.host)
        with span("hypers"):
            chains = unstack_states(st, C)
            w_lane, hyp = lane_inputs(network, chains)
            aux_lane = (None if st.aux is None else
                        {k: v.reshape(-1) for k, v in st.aux.items()})
            if mesh is None:
                Y, Xf, Xt = concat_datas(datas)  # they concatenate in time
                Y_lane = Y.repeat(1, C)                           # (T, C*N)
                shard = path = None
            else:
                Y, Xf, Xt = _concat_rows(mesh_rows(datas, mesh), N,
                                         N * B + 1, w_lane.device)
                Y_lane = Y[:, on("cols", cols, Y.device)]
                w_lane = w_lane[:, lanes].contiguous()
                hyp = lane_hypers(hyp, lanes)
                if aux_lane is not None:
                    aux_lane = {k: v[lanes] for k, v in aux_lane.items()}
                shard = lane_sh._replace(generator=rep.host)
                path = mesh_ss_path(precision,
                                    whole_rows=any(d.whole for d in datas))

        with span("psi"):
            psi = Xf @ w_lane
        with span("pg_draws"):
            if beta_lane is None:
                omega, kappa = obs.omega_kappa(pg_gen, Y_lane, psi, aux_lane)
            else:
                omega, kappa = obs.tempered_omega_kappa(
                    pg_gen, Y_lane, psi, aux_lane,
                    on("beta", beta_lane, psi.device))
        with span("weights"):
            if spike_slab:
                A_lane, w_lane, u, _ = resample_spike_slab_tspace(
                    rep.device, Xt, omega, kappa, psi, w_lane, hyp, B,
                    group=group, precision=precision,
                    host_generator=rep.host, path=path, mesh=mesh)
                psi = (kappa - u) / omega
                del u
            else:
                J, h = sufficient_stats(Xf, omega, kappa, t_chunk, mesh=mesh)
                eps = None
                if mesh is not None:    # drawn at full width, as unsharded
                    eps = torch.randn((C * N, Xf.shape[1]),
                                      generator=rep.device,
                                      device=psi.device)[lanes].contiguous()
                w_lane = resample_dense(rep.device, J, h, hyp, B, eps=eps)
                A_lane = torch.ones((N, w_lane.shape[1]),
                                    dtype=torch.float32, device=w_lane.device)
                psi = Xf @ w_lane
            del omega, kappa
        with span("aux"):
            aux_lane = obs.resample_aux(pg_gen, aux_lane, Y_lane, psi,
                                        shard=shard)
        with span("loglik"):
            ll_el = obs.log_likelihood(Y_lane, psi, aux_lane)
            if mesh is None:
                lls = ll_el.reshape(-1, C, N).sum(dim=(0, 2))
            else:
                lls = shard.full(ll_el.sum(0)).reshape(C, N).sum(1)
        if mesh is not None:
            Aw = all_gather(torch.cat([A_lane, w_lane]), mesh, LA, dim=1)
            A_lane, w_lane = Aw[:N], Aw[N:]
            if aux_lane is not None:
                aux_lane = {k: shard.gather(v) for k, v in aux_lane.items()}

        w_c = _from_lanes(w_lane, C)                              # (C, P, N)
        W, b = map(torch.stack, zip(*(unpack_weights(w, N, B) for w in w_c)))
        A = _from_lanes(A_lane, C).contiguous()                   # (C, N, N)
        aux = (None if aux_lane is None else
               {k: v.reshape(C, N) for k, v in aux_lane.items()})
        with span("network"):
            if batched_net:
                net = network.resample(rep, st.net, A, W)
            else:
                net = _stack([network.resample(rep, s.net, A[c], W[c])
                              for c, s in enumerate(chains)])
        diag = {"log_likelihood": lls, "n_edges": A.sum(dim=(1, 2))}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def make_stacked_sweep_sharded(obs, network, N: int, B: int, C: int, mesh,
                               spike_slab: bool, t_chunk: int = 512,
                               group: int | None = None,
                               precision: str = "highest", betas=None):
    """Chains spread over a ("chain",) mesh of M ranks: each rank runs the
    ordinary stacked sweep for its C/M chains (betas, if given, its C/M
    rungs') on the whole dataset, with no collectives: chains are
    independent. The rank calls the returned sweep with its own generators
    (salted by its chain index, :func:`chain_rank_generators`) on its
    slice of the stacked state. ValueError unless M divides C."""
    from pyglm_tpu_torch.parallel.sharding import CHAIN_AXES, require_mesh
    require_mesh(mesh, CHAIN_AXES)
    M = mesh.shape["chain"]
    if C % M:
        raise ValueError(f"n_chains={C} must be divisible by the chain mesh "
                         f"size {M}")
    c = slice(mesh.index("chain") * (C // M), (mesh.index("chain") + 1)
              * (C // M))
    return make_stacked_sweep(obs, network, N, B, C // M, spike_slab,
                              t_chunk, group=group, precision=precision,
                              betas=None if betas is None
                              else np.asarray(betas)[c])


def make_stacked_sweep_gspmd(obs, network, N: int, B: int, C: int, mesh,
                             spike_slab: bool, t_chunk: int = 512,
                             group: int | None = None,
                             precision: str = "highest", betas=None):
    """Chains over a ("chain", "time", "neuron") mesh: the stacked sweep of
    all C chains with the C*N lanes sharded jointly over ("chain",
    "neuron") and the sums over "time" (``make_stacked_sweep(mesh=)``).
    The lane kernels do not care which chain a lane belongs to, so a
    rank's block may straddle two chains. ValueError unless n_chain
    divides C and n_neuron divides N."""
    from pyglm_tpu_torch.parallel.sharding import (CHAIN_DATA_AXES,
                                                   require_mesh)
    require_mesh(mesh, CHAIN_DATA_AXES)
    if C % mesh.shape["chain"]:
        raise ValueError(f"n_chains={C} must be divisible by the chain mesh "
                         f"axis {mesh.shape['chain']}")
    if N % mesh.shape["neuron"]:
        raise ValueError(f"N={N} must be divisible by the neuron mesh axis "
                         f"{mesh.shape['neuron']}")
    return make_stacked_sweep(obs, network, N, B, C, spike_slab, t_chunk,
                              group=group, precision=precision, betas=betas,
                              mesh=mesh)


def chain_data_shardings(mesh, st, datas):
    """The datasets as a rank of a ("chain", "time", "neuron") mesh holds
    them: its rows over "time" (design rows are the same rows of the whole
    design, bit for bit), or the whole rows, flagged ``whole``, where the
    time axis does not divide T; every rank holds every column and the
    whole stacked state (the counterpart of the JAX package's
    NamedShardings, which place the stacked state over "chain"). Returns
    (st, local datas)."""
    from pyglm_tpu_torch.parallel.sharding import time_rows
    out = []
    for d in datas:
        r, whole = time_rows(mesh, d.Y.shape[0])
        if whole:
            out.append(d._replace(whole=True))
            continue
        out.append(d._replace(Y=d.Y[r], Xf=d.Xf[r].contiguous(),
                              Xt=None if d.Xt is None
                              else d.Xt[:, r].contiguous(),
                              llc=None, Gg0=None, Gfull=None, XtY=None))
    return st, tuple(out)


def chain_rank_generators(seed: int, mesh, device) -> Generators:
    """The stacked sweep's generators of this rank of a chain mesh: those
    of the unsharded sweep (``seeds[0] + _SWEEP_SALT``) on chain rank 0,
    salted by the chain index above the seed's bits on the others."""
    return chain_generators(int(seed) + (mesh.index("chain") << 20), device)


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

    `mesh`: a ("chain",) mesh (:func:`make_stacked_sweep_sharded`: each
    rank sweeps C/M chains on the whole data) or a ("chain", "time",
    "neuron") mesh (:func:`make_stacked_sweep_gspmd`); every rank of it
    calls this and gets the same result. Chain c starts from
    ``ensemble_generators(seeds[c])`` as without a mesh, so the initial
    states are the same; on a chain mesh each rank's sweep generators are
    salted by its chain index, and the results are gathered over "chain".
    """
    from pyglm_tpu_torch.parallel.sharding import (
        CHAIN_AXES, gather_tree, require_mesh, shard_generators)
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
    kw = dict(t_chunk=model.t_chunk, group=model.group,
              precision=model.precision)
    obs, net, N, B = model.observation, model.network, model.N, model.B
    datas = tuple(model.datas)
    gens = chain_generators(int(seeds[0]) + _SWEEP_SALT, dev)
    chain_mesh = mesh is not None and require_mesh(mesh).axis_names \
        == CHAIN_AXES
    if chain_mesh:
        sweep = make_stacked_sweep_sharded(obs, net, N, B, C, mesh,
                                           model.spike_and_slab, **kw)
        Cl = C // mesh.shape["chain"]
        mine = seeds[mesh.index("chain") * Cl:(mesh.index("chain") + 1) * Cl]
        gens = chain_rank_generators(int(seeds[0]) + _SWEEP_SALT, mesh, dev)
    elif mesh is not None:
        sweep = make_stacked_sweep_gspmd(obs, net, N, B, C, mesh,
                                         model.spike_and_slab, **kw)
        mine, Cl = seeds, C
        gens = MeshGenerators(gens, shard_generators(
            int(seeds[0]) + _SWEEP_SALT, mesh, dev))
        datas = chain_data_shardings(mesh, None, datas)[1]
    else:
        sweep = make_stacked_sweep(obs, net, N, B, C, model.spike_and_slab,
                                   **kw)
        mine, Cl = seeds, C
    st = stack_states([init_state_from_prior(
        ensemble_generators(sd, dev), obs, net, N, B,
        model.spike_and_slab, dev) for sd in mine])

    def gather(x, dim):
        return gather_tree(x, mesh, "chain", dim) if chain_mesh else x

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
        lls = (torch.stack(lls) if lls else
               torch.zeros((0, Cl), dtype=torch.float32, device=dev))
        return {"A_mean": gather(accA / n_samples, 0).cpu().numpy(),
                "Weff_mean": gather(accW / n_samples, 0).cpu().numpy(),
                "lls": gather(lls, 1).cpu().numpy(),
                "final_states": unstack_states(gather(st, 0), C)}

    out = {"A": [], "W": [], "bias": [], "lls": []}
    for _ in range(n_samples):
        for _ in range(thin):
            st, diag = sweep(gens, st, datas)
        for k, v in (("A", st.A), ("W", st.W), ("bias", st.b),
                     ("lls", diag["log_likelihood"])):
            out[k].append(v.cpu())
    shapes = {"A": (0, Cl, N, N), "W": (0, Cl, N, N, B), "bias": (0, Cl, N),
              "lls": (0, Cl)}
    stacked = {k: gather(torch.stack(v) if v else
                         torch.zeros(shapes[k], dtype=torch.float32),
                         1).numpy()
               for k, v in out.items()}
    return [{k: stacked[k][:, c] for k in stacked} for c in range(C)]
