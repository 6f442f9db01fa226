"""The Gibbs sweep, the log-likelihood and autoregressive generation
(PyTorch counterpart of ``pyglm_tpu/models/sweep.py``: the spike-and-slab
and the dense sweep, each with the Gaussian family's cached Grams).

PyTorch runs eagerly, so a sweep is a plain function
``sweep(generators, state, datas) -> (state, diagnostics)`` and generation
is a Python loop over time bins.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pyglm_tpu_torch.diagnostics.profiling import span
from pyglm_tpu_torch.models.weights import (
    check_precision, check_t_chunk, pack_weights, resample_dense,
    resample_spike_slab_tspace, sufficient_stats, unpack_weights,
)
from pyglm_tpu_torch.ops.linalg import chol_small, solve_lower_t_small
from pyglm_tpu_torch.utils.utils import fp32_matmul, logistic


class GLMData(NamedTuple):
    Y: torch.Tensor            # (T, N) observations
    Xf: torch.Tensor           # (T, P) design, last column = ones
    Xt: torch.Tensor | None    # (P, T) the same design, presyn-major rows
    llc: dict | None = None    # the family's ll_cache(Y), or None
    # The unweighted Gram statistics of a Gaussian family (omega = 1/eta is
    # constant over time, so X' Omega X is a Gram divided by eta): made
    # once at add_data, read by the single-chain sweep.
    Gg0: torch.Tensor | None = None     # (Ng, GB(GB+1)/2, 1) packed group
                                        # Grams (spike-and-slab)
    Gfull: torch.Tensor | None = None   # (P, P) full Gram (dense)
    XtY: torch.Tensor | None = None     # (P, N) X' Y (dense)
    # On a mesh: True where T is not divisible by the time axis, so every
    # time rank holds the whole rows and only time rank 0 sums them.
    whole: bool = False


class GLMState(NamedTuple):
    A: torch.Tensor     # (N, N) adjacency, A[pre, post] in {0, 1}
    W: torch.Tensor     # (N, N, B) weights (0 where A == 0)
    b: torch.Tensor     # (N,) biases
    aux: object         # family aux params: {"r": (N,)} for NB,
                        # {"eta": (N,)} for the Gaussian, else None
    net: object         # network-prior state (host tensors)


class Generators(NamedTuple):
    """A model's random streams: `device` draws tensors on the model's
    device; `host` (a CPU generator) draws the O(B^2) network updates and
    the Philox seeds of the kernels, so neither waits on the device."""
    device: torch.Generator
    host: torch.Generator


class MeshGenerators(NamedTuple):
    """A sharded model's random streams: `replicated`, the same on every
    rank and consumed in lockstep (the weight update's noise, the bias
    normals, the "sr" seeds, the auxiliary and network draws, the swaps),
    and `shard`, this rank's own (parallel/sharding.py::shard_generators:
    the PG draws and CRT counts of its tile)."""
    replicated: Generators
    shard: Generators


def concat_datas(datas):
    """(Y, Xf, Xt) of the datasets concatenated along time."""
    if len(datas) == 1:
        return datas[0].Y, datas[0].Xf, datas[0].Xt
    return (torch.cat([d.Y for d in datas]), torch.cat([d.Xf for d in datas]),
            torch.cat([d.Xt for d in datas], dim=1))


def make_gibbs_sweep(obs, network, N: int, B: int, spike_slab: bool,
                     t_chunk: int = 512, group: int | None = None,
                     precision: str = "highest", mesh=None):
    """One Gibbs sweep (the JAX package's move order):
      1. psi = Xf w;  (omega, kappa) from the family: PG(1, psi) by K1 for
         Bernoulli, PG(y + r, psi) or PG(n, psi) by K4 for NB and Binomial,
         1/eta and y/eta for the Gaussian
      2. (A, W, bias): spike-and-slab, the collapsed update at `precision`
         (models/weights.py: K2 + K3 or K6 + K3; "sr" draws K2's rounding
         seeds from the host generator); dense, J = X' Omega X and
         h = X' kappa per dataset (fp32 at every mode), summed, then one
         batched Gaussian draw, A = 1
      3. observation aux, then the network hyperparameters given (A, W)
    A Gaussian family with its cached Grams (GLMData.Gg0, or Gfull and XtY)
    takes them divided by eta instead of forming X' Omega X: the sparse
    update runs the staged loop on the scaled packed Gram (no K6 in the
    sweep), the dense one draws from the scaled full Gram.
    Returns (new_state, {"log_likelihood", "n_edges"}), both 0-d tensors,
    plus "hmc_accept" when the network state carries one.
    Its stages are spans of ``diagnostics.profiling``: "hypers" (the
    packed weights and edge priors), "psi", "pg_draws", "weights" (the
    update of (A, W, bias)), "aux", "network" and "loglik".
    `t_chunk` is the steps of T in each fp32 partial sum of the dense J and
    h (:func:`models.weights.sufficient_stats`), the only sums it reaches,
    as in the JAX package it reaches only the XLA paths: the kernels keep
    their own splits of T.
    The datasets' ll caches are additive summaries (counts, scalar sums),
    so their sum stands for the concatenated data; it feeds the total
    log-likelihood and the NB collapsed-CRT r update.

    With a ("time", "neuron") `mesh` it is one rank's sweep of a sharded
    model, ``sweep(MeshGenerators, local state, local datas)``. The local
    state holds the rank's lanes (A[:, lanes], W[:, lanes], b[lanes], the
    aux's lanes) and the replicated network state; a local dataset holds
    the rank's rows of Y (every column), of the design and of its
    transpose, and its add_data tables summed over "time" at the rank's
    lanes (parallel/sharding.py::shard_model). psi and the PG draws run on
    the rank's (rows, lanes) tile from its shard generators (K1 or K4 at
    the local shape); the weight update runs on the mesh (models/
    weights.py: the mesh-fused K2 + K3 loop, or the staged one; the dense
    J and h summed over "time"); (A, W) are gathered over the lane axes;
    the aux is drawn at full width from time-summed, gathered sums; the
    network resample runs replicated from the replicated generators; the
    log-likelihood is summed over both axes. Every rank returns the same
    diagnostics.
    """
    t_chunk = check_t_chunk(t_chunk)
    if mesh is not None:
        from pyglm_tpu_torch.models.weights import lane_hypers, mesh_ss_path
        from pyglm_tpu_torch.parallel.sharding import (
            all_gather, lane_axes, lane_shard)
        lane_sh = lane_shard(mesh, N)
        lanes = lane_sh.lanes

    def rows(datas, dev):
        """(Y at the rank's lanes, Xf, Xt) of the rows this rank sums."""
        if mesh is None:
            return concat_datas(datas)
        return local_rows(datas, mesh, N, B, lanes, dev)

    def psi_pg(pg_gen, Y, Xf, w_full, aux):
        """(psi, omega, kappa) of one dataset's rows."""
        with span("psi"):
            psi = Xf @ w_full
        with span("pg_draws"):
            return (psi, *obs.omega_kappa(pg_gen, Y, psi, aux))

    def spike_slab_update(rep, pg_gen, w_full, hyp, datas, aux):
        Y, Xf, Xt = rows(datas, w_full.device)
        psi, omega, kappa = psi_pg(pg_gen, Y, Xf, w_full, aux)
        Jg = None
        if all(d.Gg0 is not None for d in datas):
            # (Ng, GB(GB+1)/2, 1) / eta along the lane axis
            Jg = sum(d.Gg0 for d in datas) / aux["eta"]
        path = None if mesh is None else mesh_ss_path(
            precision, jg_given=Jg is not None,
            whole_rows=any(d.whole for d in datas))
        with span("weights"):
            A, w_full, u, _ = resample_spike_slab_tspace(
                rep.device, Xt, omega, kappa, psi, w_full, hyp, B,
                group=group, precision=precision, host_generator=rep.host,
                Jg=Jg, path=path, mesh=mesh)
            # psi under the NEW weights, recovered without a second matmul.
            psi = (kappa - u) / omega
        return A, w_full, Y, psi

    def dense_update(rep, pg_gen, w_full, hyp, datas, aux):
        if all(d.Gfull is not None for d in datas):
            inv_eta = 1.0 / aux["eta"]
            J = sum(d.Gfull for d in datas)[None] * inv_eta[:, None, None]
            h = sum(d.XtY for d in datas) * inv_eta
        elif mesh is None:
            J = h = 0.0
            for d in datas:
                _, omega, kappa = psi_pg(pg_gen, d.Y, d.Xf, w_full, aux)
                with span("weights"):
                    Jd, hd = sufficient_stats(d.Xf, omega, kappa, t_chunk)
                J, h = J + Jd, h + hd
        else:
            Y, Xf, _ = rows(datas, w_full.device)
            _, omega, kappa = psi_pg(pg_gen, Y, Xf, w_full, aux)
            with span("weights"):
                J, h = sufficient_stats(Xf, omega, kappa, t_chunk, mesh=mesh)
        with span("weights"):
            eps = None
            if mesh is not None:        # drawn at full width, as unsharded
                eps = torch.randn((N, N * B + 1), generator=rep.device,
                                  device=w_full.device)[lanes].contiguous()
            w_full = resample_dense(rep.device, J, h, hyp, B, eps=eps)
        Y, Xf, _ = rows(datas, w_full.device)
        A = torch.ones((N, w_full.shape[1]), dtype=torch.float32,
                       device=w_full.device)
        with span("psi"):
            psi = Xf @ w_full
        return A, w_full, Y, psi

    update = spike_slab_update if spike_slab else dense_update

    @fp32_matmul()
    def sweep(gens, state: GLMState, datas):
        rep, pg_gen = ((gens, gens.host) if mesh is None
                       else (gens.replicated, gens.shard.host))
        with span("hypers"):
            w_full = pack_weights(state.A, state.W, state.b)
            hyp = network.edge_hypers(state.net, w_full.device)
            if mesh is not None:
                hyp = lane_hypers(hyp, lanes)
        llc = sum_caches(datas)
        A, w_full, Y, psi = update(rep, pg_gen, w_full, hyp, datas,
                                   state.aux)
        W, b = unpack_weights(w_full, N, B)
        A_all, W_all, shard = A, W, None
        if mesh is not None:
            Aw = all_gather(torch.cat([A, w_full]), mesh, lane_axes(mesh),
                            dim=1)                            # one gather
            A_all, W_all = Aw[:N], unpack_weights(Aw[N:], N, B)[0]
            shard = lane_sh._replace(generator=rep.host)
        with span("aux"):
            aux = obs.resample_aux(pg_gen, state.aux, Y, psi, cache=llc,
                                   shard=shard)
        with span("network"):
            net = network.resample(rep, state.net, A_all, W_all)
        with span("loglik"):
            ll = total_log_likelihood(obs, Y, psi, aux, llc, mesh)
        diag = {"log_likelihood": ll, "n_edges": A_all.sum()}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def mesh_rows(datas, mesh):
    """The datasets whose rows this rank sums: every time-sharded one, and
    on time rank 0 also those whose whole rows every time rank holds."""
    t0 = mesh.index("time") == 0
    return [d for d in datas if t0 or not d.whole]


def _concat_rows(datas, N: int, P: int, dev):
    """concat_datas of `datas`, or empty (0, N), (0, P), (P, 0) tensors."""
    if datas:
        return concat_datas(datas)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.zeros((0, N), **f32), torch.zeros((0, P), **f32),
            torch.zeros((P, 0), **f32))


def local_rows(datas, mesh, N: int, B: int, lanes: slice, dev):
    """(Y at the rank's `lanes`, Xf, Xt) of the rows this rank sums."""
    Y, Xf, Xt = _concat_rows(mesh_rows(datas, mesh), N, N * B + 1, dev)
    return Y[:, lanes].contiguous(), Xf, Xt


def sum_caches(datas):
    """The datasets' ll caches added up (None if one has none): additive
    summaries that stand for the concatenated data."""
    caches = [d.llc for d in datas]
    if not caches or any(c is None for c in caches):
        return None
    return {k: sum(c[k] for c in caches) for k in caches[0]}


def total_log_likelihood(obs, Y, psi, aux, llc, mesh=None):
    """The family's log_likelihood_sum; on a `mesh`, of this rank's rows
    and lanes, summed over every rank, with the time-summed cache counted
    once (on time rank 0). A 0-d tensor."""
    if mesh is None:
        return obs.log_likelihood_sum(Y, psi, aux, llc)
    from pyglm_tpu_torch.parallel.sharding import all_reduce_sum
    if llc is not None and mesh.index("time") != 0:
        llc = {k: torch.zeros_like(v) for k, v in llc.items()}
    ll = obs.log_likelihood_sum(Y, psi, aux, llc)
    return all_reduce_sum(ll.reshape(1), mesh, mesh.axis_names)[0]


def make_log_likelihood(obs, N: int, B: int, precision: str = "highest"):
    """log p(Y | state) of one dataset, a 0-d tensor: psi = Xf w, then the
    family's log_likelihood_sum. `precision` is the JAX package's parameter
    (one of the four modes; ValueError otherwise); psi is a full float32
    GEMM at every mode, as in the sweep, so the value equals the sweep's
    own log-likelihood at every mode (the JAX package's einsum takes the
    mode's precision)."""
    check_precision(precision)

    @fp32_matmul()
    def log_likelihood(state: GLMState, data: GLMData):
        psi = data.Xf @ pack_weights(state.A, state.W, state.b)
        return obs.log_likelihood_sum(data.Y, psi, state.aux)
    return log_likelihood


def make_generator(obs, N: int, B: int):
    """Autoregressive forward simulation: a loop over time bins, each bin
    read from the L bins before it. The family's psi-independent noise for
    all T bins (Bernoulli's uniforms, NB's Gamma(r) factors) is drawn
    before the loop, so a bin costs one draw that needs no host sync, and
    the bin's output goes straight to its row of a (L + T, N) buffer whose
    first L rows hold the history, so rows t .. t+L-1 are bin t's window
    in time order: a bin launches the two GEMMs, the bias add (into psi's
    row), the draw and one copy. ``uniforms`` (T, N), if given, replaces a
    Bernoulli family's uniforms (for reproducing a reference run).
    ``ring0`` (L, N), the last L bins of observed history in time order,
    starts the buffer, so that generation continues from the data (a
    posterior-predictive forecast); None starts from silence."""

    @fp32_matmul()
    def generate(generator: torch.Generator, state: GLMState, basis, T: int,
                 uniforms=None, ring0=None):
        dev = state.b.device
        basis = torch.as_tensor(basis, dtype=torch.float32, device=dev)
        L = basis.shape[0]
        basis_rev = basis.flip(0)                                # (L, B)
        W2 = (state.A[:, :, None] * state.W).permute(0, 2, 1).reshape(
            N * B, N)                                            # (N*B, N)
        Yp = torch.zeros((L + T, N), dtype=torch.float32, device=dev)
        if ring0 is not None:
            Yp[:L] = torch.as_tensor(ring0, dtype=torch.float32, device=dev)
        noise = (obs.sample_noise(generator, (T, N), state.aux)
                 if uniforms is None else uniforms)
        psi = torch.empty((T, N), dtype=torch.float32, device=dev)
        for t in range(T):
            F = Yp[t:t + L].T @ basis_rev                        # (N, B)
            psi_t = torch.add(state.b, F.reshape(-1) @ W2, out=psi[t])
            Yp[t + L] = obs.sample(generator, psi_t, state.aux,
                                   None if noise is None else noise[t])
        return Yp[L:], psi

    return generate


def init_state_from_prior(gens: Generators, obs, network, N: int, B: int,
                          spike_slab: bool, device) -> GLMState:
    """Draw (A, W, b, aux, net) from the model prior: the network state,
    then A ~ Bern(logistic(logit_rho)), W and b."""
    net = network.init_state(gens, device)
    hyp = network.edge_hypers(net, device)
    g = gens.device
    if spike_slab:
        A = (torch.rand((N, N), generator=g, device=device)
             < logistic(hyp.logit_rho)).to(torch.float32)
    else:
        A = torch.ones((N, N), dtype=torch.float32, device=device)
    # W ~ N(mu, Lam^{-1}) on every edge: with Lam = L L', mu + L^{-T} eps.
    eps = torch.randn((N, N, B), generator=g, device=device)
    W = hyp.mu + solve_lower_t_small(chol_small(hyp.Lam), eps)
    W = W * A[:, :, None]
    b = hyp.mu_b + torch.randn((N,), generator=g, device=device) / torch.sqrt(
        hyp.lam_b)
    return GLMState(A, W, b, obs.init_aux(N, device), net)
