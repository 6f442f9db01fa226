"""User-facing model classes (PyTorch counterpart of
``pyglm_tpu/models/glm.py``): the network GLM with Bernoulli, Binomial,
negative-binomial or Gaussian observations, dense or spike-and-slab
weights, and a dense, Erdos-Renyi, stochastic-block or latent-distance
prior; the multi-chain ``fit_ensemble``; and the convenience classes.

The class is a thin stateful shell: the chain state is a ``GLMState`` of
tensors on the model's `device` (the card unless the caller asks for the
CPU), and one ``resample_model`` call is one Gibbs sweep (models/sweep.py).
Randomness comes from the model's own generators, seeded from `seed`.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from pyglm_tpu_torch.diagnostics.profiling import span, wait
from pyglm_tpu_torch.models.ensemble import (
    _CHAIN_SALT, chain_generators, ensemble_generators, run_stacked_chains,
)
from pyglm_tpu_torch.models.networks import make_network
from pyglm_tpu_torch.models.observations import make_observation
from pyglm_tpu_torch.models.sweep import (
    GLMData, GLMState, Generators, MeshGenerators, init_state_from_prior,
    local_rows, make_generator, make_gibbs_sweep, make_log_likelihood,
    sum_caches, total_log_likelihood,
)
from pyglm_tpu_torch.models.weights import (
    _auto_group, check_precision, check_t_chunk, group_gram_blocks,
    pack_weights, sufficient_stats,
)
from pyglm_tpu_torch.ops.basis import (
    cosine_basis, design_matrix, design_matrix_sharded,
)
from pyglm_tpu_torch.utils.convert import state_to_numpy
from pyglm_tpu_torch.utils.metrics import split_rhat
from pyglm_tpu_torch.utils.utils import as_f32, fp32_matmul, require_device


class NonlinearAutoregressiveModel:
    """Fully-Bayesian network GLM of spike trains (Gibbs inference).

    psi[t, n] = b[n] + sum_j A[j,n] sum_k W[j,n,k] (Y[:,j] * basis_k)(t-1)
    Y[t, n] ~ observation(link(psi[t, n])),  (A, W) ~ network prior.

    Args:
      N: number of neurons.
      B, L: basis dimension / filter length (ignored if `basis` given).
      basis: optional (L, B) filter matrix.
      observation, network: family / prior names or config objects:
        'bernoulli', 'binomial', 'negative_binomial' or 'gaussian', and
        'dense', 'erdos_renyi', 'sbm' or 'latent_distance'.
      spike_and_slab: the collapsed spike-and-slab update of (A, W), or
        (False, the default) the dense update with A = 1.
      seed: seed of this model's generators.
      t_chunk: steps of T in each fp32 partial sum of the dense update's
        J = X' Omega X and h (and of a dense Gaussian's cached Gram), the
        JAX package's parameter; it reaches no kernel, as in the JAX
        package it reaches only the XLA paths.
      precision: the accuracy of the spike-and-slab Gram, as in the JAX
        package. The loop is the fused K2 + K3 where the JAX dispatcher
        picks it (the flagship) and else the staged K6 + K3.
        'high' (default): on the card the Gram runs 3xTF32 on the tensor
        cores (fp32-grade, as the JAX package's bf16x3): K2's Gram, or K6's
        "high" body. 'default': one bf16 pass on the tensor cores (Z and
        omega rounded to nearest even, fp32 sums): K2's bf16 Gram on one
        bf16 stream of omega made once for the whole fused update (u0, the
        scatter, sum omega; the bias draw keeps the fp32 omega), or K6's
        bf16 body;
        the fastest, with ~1e-3 relative error in the Gram. 'sr': in the
        fused loop K2's bf16 pass on a stochastically rounded Z (unbiased;
        its Philox seeds come from the host generator), and in the staged
        loop the 'high' Gram, as the JAX package runs it. 'highest': the
        staged loop with K6's fp32 FMA body, never K2. On the CPU the plain
        versions round as the card does at 'default' and 'sr' (the same
        words at 'sr'), and 'high' and 'highest' run in fp32. The psi and
        log-likelihood GEMMs, M0 and K2's scatter stay fp32-grade at every
        mode, and so does the whole dense update (J = X' Omega X, h and
        psi in fp32: every mode gives the same dense draw, where the JAX
        package's "default" runs J as one bf16 pass on the TPU). A Gaussian
        spike-and-slab model's cached group Gram (made once at add_data by
        K6) takes the mode's K6 body. log_likelihood() runs psi in fp32 at
        every mode, as the sweep does (make_log_likelihood).
      group: presyn neurons per spike-and-slab group (default: the divisor
        of N nearest 8 with group*B % 8 == 0, i.e. 8 at N = 200, B = 4).
      device: where the data, the state and the kernels live: the card
        by default; pass device='cpu' to run the plain versions on the CPU.
        Raises RuntimeError if the device is a card and none is present.

    :meth:`shard` spreads one model over the ranks of a ("time", "neuron")
    mesh (parallel/sharding.py); ``fit_ensemble(mesh=)`` and
    ``fit_tempered(mesh=)`` spread chains or rungs over a ("chain",) or
    ("chain", "time", "neuron") mesh. Every rank builds the same model and
    makes the same calls; each returns the same global result on every
    rank.
    """

    def __init__(self, N: int, B: int = 4, L: int = 10, basis=None,
                 observation="bernoulli", network="dense",
                 spike_and_slab: bool = False, seed: int = 0,
                 t_chunk: int = 512, precision: str = "high",
                 group: int | None = None, device="cuda",
                 obs_kwargs: Optional[dict] = None,
                 net_kwargs: Optional[dict] = None):
        with span("init"):
            check_precision(precision)
            self.t_chunk = check_t_chunk(t_chunk)
            if basis is None:
                basis = cosine_basis(B=B, L=L)
            basis = np.asarray(basis, np.float32)
            self.N = N
            self.L, self.B = basis.shape
            self.basis = basis
            self.spike_and_slab = bool(spike_and_slab)
            self.precision = precision
            self.device = require_device(device)
            self.observation = (
                make_observation(observation, **(obs_kwargs or {}))
                if isinstance(observation, str) else observation)
            self.network = (make_network(network, N=N, B=self.B,
                                         **(net_kwargs or {}))
                            if isinstance(network, str) else network)
            self.group = _auto_group(N, self.B) if group is None else group
            self.seed = int(seed)
            self.generators = chain_generators(seed, self.device)
            # Set by shard(): the mesh, and this rank's per-shard generators.
            self._mesh = None
            self.shard_generators: Generators | None = None

            self._sweep = make_gibbs_sweep(
                self.observation, self.network, N, self.B,
                self.spike_and_slab, self.t_chunk, group=self.group,
                precision=self.precision)
            self._loglik = make_log_likelihood(self.observation, N, self.B,
                                               precision=self.precision)
            self._generate = make_generator(self.observation, N, self.B)
            self.state: GLMState = init_state_from_prior(
                self.generators, self.observation, self.network, N, self.B,
                self.spike_and_slab, self.device)
            self.datas: list[GLMData] = []

    @property
    def P(self) -> int:
        return self.N * self.B + 1

    def add_data(self, Y) -> None:
        """Register a (T, N) spike matrix: builds the design (T, P), its
        transpose (P, T) and the family's ll cache on the model's device,
        and for a Gaussian family its unweighted Grams: the packed group
        Grams (K6 on one lane of ones, at the model's precision) for
        spike-and-slab, else the full Gram and X'Y (fp32).
        Raises ValueError if a count exceeds the family's `max_y`.

        On a sharded model every rank passes the whole Y and keeps its rows
        (``parallel.sharding.shard_model`` says how)."""
        with span("add_data"):
            Y = as_f32(Y, self.device)
            if Y.ndim != 2 or Y.shape[1] != self.N:
                raise ValueError(f"expected (T, {self.N}) data, got "
                                 f"{tuple(Y.shape)}")
            max_y = getattr(self.observation, "max_y", None)
            if max_y is not None:
                # The CRT r update sums max_y tables: a larger count would
                # be dropped silently, biasing the r conditional.
                y_max = float(Y.max())
                if y_max > max_y:
                    raise ValueError(
                        f"max observed count {y_max:.0f} exceeds the "
                        f"observation family's max_y={max_y}; construct "
                        f"with obs_kwargs=dict(max_y={int(y_max)}) or "
                        f"larger so the CRT dispersion update sees every "
                        f"count")
            self.datas.append(self._ingest(Y, self._mesh))

    def _ingest(self, Y, mesh=None) -> GLMData:
        """The GLMData of a whole (T, N) Y: on a `mesh`, this rank's rows of
        Y and of the design (``design_matrix_sharded``: its rows of Y and
        the L bins before them, from the previous time rank), and the
        tables at its lanes summed over "time"; a T that the time axis
        does not divide into blocks of at least L rows keeps its whole
        rows, with a warning, and sums nothing over "time"."""
        whole, lanes = False, slice(None)
        if mesh is not None:
            from pyglm_tpu_torch.parallel.sharding import (
                all_reduce_sum, glm_shardings)
            lay = glm_shardings(mesh, Y.shape[0], self.N, L=self.L)
            whole, lanes = lay.whole, lay.lanes
            if whole:
                warnings.warn(
                    f"sharded model: dataset with T={Y.shape[0]} keeps its "
                    f"whole rows on every time rank (needs T divisible by "
                    f"the mesh time axis {mesh.shape['time']} and a shard "
                    f"of at least L={self.L} bins); time rank 0 sums them "
                    f"and the spike-and-slab update runs the staged loop. "
                    f"Pad or trim T to a multiple of {mesh.shape['time']}",
                    stacklevel=3)
                Xf = design_matrix(Y, self.basis)
            else:
                Y = Y[lay.rows]
                Xf = design_matrix_sharded(Y, self.basis, mesh)
        else:
            Xf = design_matrix(Y, self.basis)

        def time_sum(x):
            return x if mesh is None or whole else all_reduce_sum(
                x, mesh, "time")
        Xt = Xf.T.contiguous()
        Yl = Y[:, lanes]
        Gg0 = Gfull = XtY = None
        if not self.observation.needs_pg:
            ones = Y.new_ones((Y.shape[0], 1))
            if self.spike_and_slab:
                Gg0 = time_sum(group_gram_blocks(Xt, ones, self.B,
                                                 self.group,
                                                 precision=self.precision))
            else:
                Gfull, XtY = sufficient_stats(Xf, ones, Yl, self.t_chunk)
                Gfull, XtY = time_sum(Gfull[0]), time_sum(XtY)
        llc = self.observation.ll_cache(Yl)
        if llc is not None:
            llc = {k: time_sum(v) for k, v in llc.items()}
        return GLMData(Y=Y, Xf=Xf, Xt=Xt, llc=llc, Gg0=Gg0, Gfull=Gfull,
                       XtY=XtY, whole=whole)

    def _full_state(self) -> GLMState:
        """The whole state: this model's, or on a sharded model its lanes
        gathered from every rank."""
        if self._mesh is None:
            return self.state
        from pyglm_tpu_torch.parallel.sharding import gather_state
        return gather_state(self.state, self._mesh)

    def _gens(self):
        return (self.generators if self._mesh is None else
                MeshGenerators(self.generators, self.shard_generators))

    def generate(self, T: int, keep: bool = True):
        """Sample a (T, N) spike train from the current parameters (on a
        sharded model, the same on every rank: the whole state, the
        replicated generator)."""
        Y, _ = self._generate(self.generators.device, self._full_state(),
                              self.basis, T)
        if keep:
            self.add_data(Y)
        return Y.cpu().numpy()

    def forecast(self, T_ahead: int, n_samples: int = 1, thin: int = 1,
                 data_index: int = -1):
        """Posterior-predictive simulation that continues from observed
        history: the generator's ring starts from the last L bins of
        dataset `data_index` (zeros in front if it is shorter). Before each
        of the `n_samples` futures the chain advances `thin` sweeps, so the
        futures integrate over the parameters' uncertainty. Returns
        (n_samples, T_ahead, N)."""
        if not self.datas:
            raise RuntimeError("no observed history; call add_data() first")
        ring0 = self.datas[data_index].Y[-self.L:]
        if self._mesh is not None and not self.datas[data_index].whole:
            from pyglm_tpu_torch.parallel.sharding import all_gather
            ring0 = all_gather(ring0.contiguous(), self._mesh,
                               "time")[-ring0.shape[0]:]
        if ring0.shape[0] < self.L:
            ring0 = torch.cat([ring0.new_zeros(
                (self.L - ring0.shape[0], self.N)), ring0])
        out = []
        for _ in range(n_samples):
            for _ in range(thin):
                self.resample_model()
            Y, _ = self._generate(self.generators.device,
                                  self._full_state(), self.basis, T_ahead,
                                  ring0=ring0)
            out.append(Y.cpu().numpy())
        return np.stack(out)

    def resample_model(self):
        """One Gibbs sweep over weights, adjacency, aux and network."""
        if not self.datas:
            raise RuntimeError("call add_data() or generate(keep=True) first")
        with span("resample_model", step=True):
            self.state, diag = self._sweep(self._gens(), self.state,
                                           tuple(self.datas))
            out = {}
            for k, v in diag.items():
                with wait("diag"):
                    out[k] = float(v)
        return out

    def log_likelihood(self, data=None) -> float:
        """Total log-likelihood of the registered data (or of a (T, N) Y)."""
        if data is not None:
            Y = as_f32(data, self.device)
            d = GLMData(Y=Y, Xf=design_matrix(Y, self.basis), Xt=None)
            return float(self._loglik(self._full_state(), d))
        if self._mesh is None:
            return float(sum(self._loglik(self.state, d)
                             for d in self.datas))
        from pyglm_tpu_torch.parallel.sharding import lane_slice
        mesh = self._mesh
        w = pack_weights(self.state.A, self.state.W, self.state.b)
        Y, Xf, _ = local_rows(self.datas, mesh, self.N, self.B,
                              lane_slice(mesh, self.N), self.device)
        with fp32_matmul():
            return float(total_log_likelihood(
                self.observation, Y, Xf @ w, self.state.aux,
                sum_caches(self.datas), mesh))

    def log_probability(self) -> float:
        return self.log_likelihood()

    def _gather_lanes(self, x, dim: int):
        """x with its lanes (axis `dim`) gathered on a sharded model."""
        if self._mesh is None:
            return x
        from pyglm_tpu_torch.parallel.sharding import all_gather, lane_axes
        return all_gather(x, self._mesh, lane_axes(self._mesh), dim=dim)

    @property
    def A(self) -> np.ndarray:
        """(N_pre, N_post) adjacency sample."""
        return self._gather_lanes(self.state.A, 1).cpu().numpy()

    @property
    def W(self) -> np.ndarray:
        """(N_pre, N_post, B) weight sample (zero where A == 0)."""
        return self._gather_lanes(self.state.W, 1).cpu().numpy()

    @property
    def W_effective(self) -> np.ndarray:
        """(N_pre, N_post) net synaptic weights: sum over the basis of
        A * W."""
        return self._gather_lanes(
            (self.state.A[:, :, None] * self.state.W).sum(-1),
            1).cpu().numpy()

    @property
    def bias(self) -> np.ndarray:
        return self._gather_lanes(self.state.b, 0).cpu().numpy()

    @property
    def means(self) -> list:
        """Per dataset, the observation family's mean E[y_t | history]
        (T, N) under the current sample, psi by a float32 GEMM."""
        w_full = pack_weights(self.state.A, self.state.W, self.state.b)
        with fp32_matmul():
            means = [self.observation.mean(d.Xf @ w_full, self.state.aux)
                     for d in self.datas]
        if self._mesh is not None:
            from pyglm_tpu_torch.parallel.sharding import all_gather
            means = [self._gather_lanes(m, 1) for m in means]
            means = [m if d.whole else all_gather(m, self._mesh, "time")
                     for m, d in zip(means, self.datas)]
        return [m.cpu().numpy() for m in means]

    def copy_sample(self) -> dict:
        """Host numpy snapshot of the current sample
        (``utils.convert.state_to_numpy``; ``state_from_numpy`` restores
        it)."""
        return state_to_numpy(self._full_state())

    def shard(self, mesh=None):
        """Spread this model over a ("time", "neuron") mesh of SPMD ranks
        (``parallel.sharding.shard_model``); every rank calls it on its
        copy of the same model. With no argument, the mesh
        ``best_mesh_for`` picks over the initialised world for N and the
        datasets' T (ValueError if it leaves ranks out). Returns self."""
        from pyglm_tpu_torch.parallel.sharding import (best_mesh_for,
                                                       shard_model)
        if mesh is None:
            mesh = best_mesh_for(self.N, T=[int(d.Y.shape[0])
                                            for d in self.datas])
        return shard_model(self, mesh)

    def fit(self, n_samples: int = 100, n_burnin: int = 0, thin: int = 1,
            callback=None, verbose: bool = False):
        """Run ``n_burnin + n_samples * thin`` sweeps and return every
        ``thin``-th post-burn-in sample as host arrays: 'A' (S,N,N),
        'W' (S,N,N,B), 'bias' (S,N), 'lls' (S,)."""
        samples = {"A": [], "W": [], "bias": [], "lls": []}
        for it in range(n_burnin + n_samples * thin):
            diag = self.resample_model()
            if it >= n_burnin and (it - n_burnin) % thin == thin - 1:
                samples["A"].append(self.A)
                samples["W"].append(self.W)
                samples["bias"].append(self.bias)
                samples["lls"].append(diag["log_likelihood"])
            if callback is not None:
                callback(self, it, diag)
            if verbose and it % 10 == 0:
                print(f"iter {it}: ll={diag['log_likelihood']:.1f} "
                      f"edges={diag['n_edges']:.0f}")
        empties = self._empties()
        return {k: (np.asarray(v, np.float32) if v else empties[k])
                for k, v in samples.items()}

    def fit_compiled(self, n_samples: int = 100, n_burnin: int = 0,
                     thin: int = 1, max_sweeps_per_launch: int = 250):
        """:meth:`fit`'s chain with the samples kept on the device: the
        same sweeps from the same generators, sample for sample, returning
        the same dict. The samples of a segment of at most
        `max_sweeps_per_launch` sweeps stay on the device and are copied
        to the host once per segment, where :meth:`fit` copies every
        sample; on a sharded model a segment's lanes are gathered once.
        Each sweep is still launched from Python: capturing a segment as
        one CUDA graph is later work (ROADMAP.md Queue A), and nothing
        here is claimed faster than :meth:`fit`.

        Raises ValueError if `thin` exceeds `max_sweeps_per_launch` (one
        sample would span more than one segment). A burn-only call
        returns correctly shaped empty arrays."""
        if not self.datas:
            raise RuntimeError("call add_data() or generate(keep=True) first")
        cap = max(1, max_sweeps_per_launch)
        if thin > cap:
            raise ValueError(
                f"thin={thin} exceeds max_sweeps_per_launch={cap}: one "
                f"sample would span more than one segment; raise "
                f"max_sweeps_per_launch")
        datas = tuple(self.datas)

        def sweep():
            self.state, diag = self._sweep(self._gens(), self.state, datas)
            return diag

        def sample(diag):
            return {"A": self.state.A, "W": self.state.W,
                    "bias": self.state.b, "lls": diag["log_likelihood"]}

        lane_dims = {"A": 2, "W": 2, "bias": 1}

        def gather(block):
            return {k: (self._gather_lanes(v, lane_dims[k])
                        if k in lane_dims else v) for k, v in block.items()}

        return _segments(sweep, sample, n_samples, n_burnin, thin, cap,
                         self._empties(), gather=gather)

    def _check_chain_mesh(self, mesh) -> None:
        """ValueError unless `mesh` is a connected Mesh with a "chain" axis
        and this model is unsharded (chains and rungs take the whole data
        on each rank or shard it themselves)."""
        from pyglm_tpu_torch.parallel.sharding import Mesh, require_mesh
        if isinstance(mesh, Mesh) and "chain" not in mesh.shape:
            raise ValueError("the mesh needs a 'chain' axis "
                             "(parallel.sharding.make_chain_mesh or "
                             "make_chain_data_mesh)")
        require_mesh(mesh)
        if self._mesh is not None:
            raise ValueError("chains over a mesh need an unsharded model "
                             "(the chains take the whole data); use either "
                             "shard() or mesh=")

    def _empties(self) -> dict:
        N, B = self.N, self.B
        return {"A": np.zeros((0, N, N), np.float32),
                "W": np.zeros((0, N, N, B), np.float32),
                "bias": np.zeros((0, N), np.float32),
                "lls": np.zeros((0,), np.float32)}

    def fit_ensemble(self, n_chains: int = 4, n_samples: int = 100,
                     n_burnin: int = 0, thin: int = 1, seeds=None,
                     compiled: bool = True, stacked: bool | str = "auto",
                     mesh=None, collect: str = "samples"):
        """Run `n_chains` Gibbs chains from fresh prior draws on the
        registered data, with split-R-hat over the pooled traces. Chain c
        draws from generators seeded from ``seeds[c]`` (default 1 .. C),
        salted so that it does not start from the prior draw of a model
        seeded ``seeds[c]`` (models/ensemble.py::ensemble_generators).

        ``stacked=True`` runs the C chains as one lane-stacked sweep at
        C*N postsyn lanes (models/ensemble.py); False runs the chains one
        after another, each by :meth:`fit_compiled` if ``compiled`` else
        by :meth:`fit`. "auto" (the default) is ``compiled`` on an
        unsharded model and False on a sharded one, as in the JAX package.

        ``mesh`` spreads the stacked chains over ranks: a ("chain",) mesh
        (each rank sweeps C/M chains on the whole data) or a ("chain",
        "time", "neuron") mesh (the stacked lanes over ("chain", "neuron"),
        the sums over "time"); every rank calls this and gets the same
        result. It needs an unsharded model and the stacked path, and a
        mesh with a "chain" axis (ValueError otherwise, and for anything
        that is not a ``parallel.sharding.Mesh``).

        ``collect="samples"`` returns 'A' (C,S,N,N), 'W' (C,S,N,N,B),
        'bias' (C,S,N), 'lls' (C,S), 'rhat_edge' (N,N), 'rhat_bias' (N,)
        and 'rhat_ll'. ``collect="mean"`` (stacked only; ``thin`` ignored)
        keeps no samples and returns 'A_mean', 'Weff_mean' (C,N,N), their
        chain means 'A_mean_pooled', 'Weff_mean_pooled' (N,N), 'lls' (C,S),
        'rhat_ll' and 'final_states'. The model's own state and generators
        are restored afterwards.
        """
        if not self.datas:
            raise RuntimeError("call add_data() or generate(keep=True) first")
        if n_chains < 2 or n_samples < 4:
            raise ValueError(f"fit_ensemble needs >= 2 chains of >= 4 "
                             f"samples, got {n_chains} x {n_samples}")
        if collect not in ("samples", "mean"):
            raise ValueError(f"collect must be 'samples' or 'mean', got "
                             f"{collect!r}")
        if mesh is not None:
            self._check_chain_mesh(mesh)
            if stacked not in ("auto", True):
                raise ValueError("mesh= implies the stacked path; drop "
                                 "stacked=False")
            stacked = True
        if stacked == "auto":
            stacked = self._mesh is None and compiled
        if stacked and self._mesh is not None:
            raise ValueError("the lane-stacked ensemble runs on an "
                             "unsharded model (fit_ensemble(mesh=...) "
                             "spreads it over ranks); use stacked=False on "
                             "a sharded one")
        if collect == "mean" and not stacked:
            raise ValueError("collect='mean' accumulates in the lane-stacked "
                             "sweep; it needs stacked=True")
        seeds = list(range(1, n_chains + 1) if seeds is None else seeds)
        if stacked:
            runs = run_stacked_chains(self, n_chains, n_samples=n_samples,
                                      n_burnin=n_burnin, thin=thin,
                                      seeds=seeds, mesh=mesh,
                                      collect=collect)
        else:
            state0, gens0 = self.state, self.generators
            sgens0 = self.shard_generators
            runs = []
            try:
                for sd in seeds:
                    self.generators = ensemble_generators(sd, self.device)
                    self.state = init_state_from_prior(
                        self.generators, self.observation, self.network,
                        self.N, self.B, self.spike_and_slab, self.device)
                    if self._mesh is not None:
                        from pyglm_tpu_torch.parallel.sharding import (
                            lane_slice, shard_generators, shard_state)
                        self.state = shard_state(
                            self.state, lane_slice(self._mesh, self.N))
                        self.shard_generators = shard_generators(
                            int(sd) + _CHAIN_SALT, self._mesh, self.device)
                    fit = self.fit_compiled if compiled else self.fit
                    runs.append(fit(n_samples=n_samples, n_burnin=n_burnin,
                                    thin=thin))
            finally:
                self.state, self.generators = state0, gens0
                self.shard_generators = sgens0
        if collect == "mean":
            out = runs
            out["lls"] = out["lls"].T                   # (S, C) -> (C, S)
            out["A_mean_pooled"] = out["A_mean"].mean(axis=0)
            out["Weff_mean_pooled"] = out["Weff_mean"].mean(axis=0)
            out["rhat_ll"] = float(split_rhat(out["lls"][..., None])[0])
            return out
        out = {k: np.stack([r[k] for r in runs])
               for k in ("A", "W", "bias", "lls")}
        out["rhat_edge"] = split_rhat(out["A"])
        out["rhat_bias"] = split_rhat(out["bias"])
        out["rhat_ll"] = float(split_rhat(out["lls"][..., None])[0])
        return out

    def fit_tempered(self, n_samples: int = 100, n_burnin: int = 0,
                     thin: int = 1, n_rungs: int = 8, betas=None,
                     accept: float = 0.3, pilot_sweeps: int = 200,
                     seeds=None, max_sweeps_per_launch: int | None = None,
                     mesh=None):
        """Parallel-tempered Gibbs (models/tempering.py): a ladder of
        inverse temperatures beta_1 < ... < beta_C = 1 run as one
        lane-stacked sweep, with adjacent-rung replica-exchange swaps every
        sweep. Rung c starts from a prior draw of
        ``ensemble_generators(seeds[c])`` (default seeds 1 .. C).

        Returns the cold (beta = 1) rung's thinned samples as
        :meth:`fit_compiled` does ('A', 'W', 'bias', 'lls'), plus 'betas'
        (C,); 'swap_rate' (C,), accepted swaps per attempt (interior rungs
        attempt every sweep, the two ends on their parity only, counted
        from the parity bits drawn); 'ladder_span' (beta_C - beta_1);
        'sd_ll', the pilot's sd of the log-likelihood (None when `betas`
        is given); and 'pilot_sweeps', the pilot's sweeps (a matched-budget
        comparison counts them).

        With ``betas=None`` a pilot (:meth:`fit_compiled`, `pilot_sweeps`
        burn-in and as many kept) measures sd(ll) and
        ``tempering.suggest_ladder`` spaces `n_rungs` rungs for adjacent
        acceptance ~ `accept`; the model's state and generators are
        restored after it, and a ladder narrower than 0.1 is warned about.
        `betas` must be positive, strictly ascending and end at 1
        (ValueError otherwise).

        Samples of a segment of at most `max_sweeps_per_launch` sweeps
        (default 250) stay on the device, as in :meth:`fit_compiled`
        (ValueError if `thin` exceeds it). Supported for Bernoulli and
        Binomial, NB with ``resample_r=False`` and the Gaussian with
        ``resample_eta=False`` (ValueError otherwise).

        ``mesh`` spreads the rungs over ranks: a ("chain",) mesh (each rank
        runs C/M rungs' pass on the whole data; the states move between
        ranks at the swaps) or a ("chain", "time", "neuron") mesh (the rung
        lanes over ("chain", "neuron"), the sums over "time"). Every rank
        calls this and gets the same result. Runs on an unsharded model
        only, and the mesh needs a "chain" axis (ValueError otherwise)."""
        from pyglm_tpu_torch.models import tempering

        if self._mesh is not None:
            raise ValueError("fit_tempered runs on an unsharded model "
                             "(fit_tempered(mesh=...) spreads its rungs "
                             "over ranks); temper before shard()")
        if mesh is not None:
            self._check_chain_mesh(mesh)
        if not self.datas:
            raise RuntimeError("call add_data() or generate(keep=True) first")
        cap = max(1, 250 if max_sweeps_per_launch is None
                  else max_sweeps_per_launch)
        if thin > cap:
            raise ValueError(
                f"thin={thin} exceeds max_sweeps_per_launch={cap}")
        tempering._check_tempering(self.observation)

        sd_ll, pilot_cost = None, 0
        if betas is None:
            state0, gens0 = self.state, _copy_generators(self.generators)
            try:
                pilot = self.fit_compiled(n_samples=pilot_sweeps,
                                          n_burnin=pilot_sweeps,
                                          max_sweeps_per_launch=cap)
            finally:
                self.state, self.generators = state0, gens0
            sd_ll = float(np.std(pilot["lls"]))
            betas, span = tempering.suggest_ladder(sd_ll, n_rungs,
                                                   accept=accept)
            pilot_cost = 2 * pilot_sweeps
            if span < 0.1:
                warnings.warn(
                    f"fit_tempered: the acceptance-feasible ladder is "
                    f"NARROW: {n_rungs} rungs span only "
                    f"[{betas[0]:.4f}, 1] (sd(ll)={sd_ll:.1f} bounds the "
                    f"swap-feasible rung gap at ~{span / (n_rungs - 1):.2e}"
                    f"). Such a ladder still shortens the cold chain's "
                    f"autocorrelation, but it has no rungs near a flat "
                    f"beta~0.3 posterior: covering [0.3, 1] at this sd(ll) "
                    f"would need "
                    f"~{int(np.ceil(0.7 * (n_rungs - 1) / max(span, 1e-12)))}"
                    f" rungs", stacklevel=2)
        betas = np.asarray(betas, np.float64)
        if betas.ndim != 1 or betas.shape[0] < 2:
            raise ValueError(f"betas must be a vector of >= 2 rungs, got "
                             f"shape {betas.shape}")
        if not np.all(betas > 0):
            raise ValueError(
                f"betas must be positive (got min {betas.min():.4g}); "
                f"suggest_ladder clamps its ladder to a positive floor")
        if not np.all(np.diff(betas) > 0):
            raise ValueError("betas must be strictly ascending")
        if abs(betas[-1] - 1.0) > 1e-9:
            raise ValueError(f"the cold rung must run at beta=1 (got "
                             f"betas[-1]={betas[-1]!r})")
        C = betas.shape[0]
        seeds = list(range(1, C + 1) if seeds is None else seeds)
        args = (self.observation, self.network, self.N, self.B, betas)
        kw = dict(spike_slab=self.spike_and_slab, t_chunk=self.t_chunk,
                  group=self.group, precision=self.precision)
        datas, rungs = tuple(self.datas), None
        if mesh is None:
            sweep = tempering.make_tempered_sweep(*args, **kw)
            gens = tempering.tempered_generators(seeds, self.device)
        else:
            gens = tempering.tempered_mesh_generators(seeds, mesh,
                                                      self.device)
            if "time" in mesh.shape:
                from pyglm_tpu_torch.models.ensemble import (
                    chain_data_shardings)
                sweep = tempering.make_tempered_sweep_gspmd(*args, mesh,
                                                            **kw)
                datas = chain_data_shardings(mesh, None, datas)[1]
            else:
                sweep = tempering.make_tempered_sweep_sharded(*args, mesh,
                                                              **kw)
                Cl = C // mesh.shape["chain"]
                rungs = slice(mesh.index("chain") * Cl,
                              (mesh.index("chain") + 1) * Cl)
        box = {"st": tempering.init_tempered_states(self, betas, seeds,
                                                    rungs=rungs)}
        tally = {"acc": torch.zeros(C, dtype=torch.float64), "sweeps": 0,
                 "parity1": 0}
        cold = C - 1

        def step():
            box["st"], diag = sweep(gens, box["st"], datas)
            tally["acc"] += diag["swap_accept"]
            tally["sweeps"] += 1
            tally["parity1"] += diag["swap_parity"]
            return diag

        def sample(diag):
            st = diag.get("full_state", box["st"])
            return {"A": st.A[cold], "W": st.W[cold], "bias": st.b[cold],
                    "lls": diag["log_likelihood"][cold]}

        res = _segments(step, sample, n_samples, n_burnin, thin, cap,
                        self._empties())
        res["swap_rate"] = tempering.swap_rates(
            tally["acc"], tally["sweeps"], tally["parity1"])
        res["betas"] = betas
        res["ladder_span"] = float(betas[-1] - betas[0])
        res["sd_ll"] = sd_ll
        res["pilot_sweeps"] = pilot_cost
        return res


def _copy_generators(gens: Generators) -> Generators:
    """Generators in the same state as `gens`, drawing apart from them."""
    dev, host = torch.Generator(device=gens.device.device), torch.Generator()
    dev.set_state(gens.device.get_state())
    host.set_state(gens.host.get_state())
    return Generators(dev, host)


def _segments(sweep, sample, n_samples: int, n_burnin: int, thin: int,
              cap: int, empties: dict, gather=None) -> dict:
    """`n_burnin` calls of sweep(), then `n_samples` samples, each
    sample(diag) of the `thin`-th sweep after the last, as host arrays
    stacked on a leading axis. A segment's samples (at most cap // thin of
    them) are copied into tensors on the device as they come and to the
    host once per segment, after ``gather(block)`` if given (a sharded
    model's lanes). No samples: `empties`."""
    for _ in range(n_burnin):
        sweep()
    out: dict = {}
    left = n_samples
    while left > 0:
        c = min(left, max(1, cap // thin))
        block = None
        for i in range(c):
            for _ in range(thin):
                diag = sweep()
            s = sample(diag)
            if block is None:
                block = {k: torch.empty((c,) + tuple(v.shape),
                                        dtype=v.dtype, device=v.device)
                         for k, v in s.items()}
            for k, v in s.items():
                block[k][i] = v
        if gather is not None:
            block = gather(block)
        for k, v in block.items():
            out.setdefault(k, []).append(v.cpu().numpy())
        left -= c
    if not out:
        return dict(empties)
    return {k: np.concatenate(v) for k, v in out.items()}


GLM = NonlinearAutoregressiveModel


def _merge_net_defaults(kw: dict, **defaults) -> dict:
    """Merge a convenience class's network-prior defaults under the user's
    `net_kwargs`. Unbounded links (NB's exp mean) need small weight priors
    for the forward dynamics to stay stable."""
    kw["net_kwargs"] = {**defaults, **(kw.get("net_kwargs") or {})}
    return kw


class BernoulliGLM(NonlinearAutoregressiveModel):
    """Dense Bernoulli GLM with the dense prior (on the card unless `device`
    says otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "bernoulli")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        super().__init__(N, **kw)


class SparseBernoulliGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab Bernoulli GLM with an Erdos-Renyi prior (on the card
    unless `device` says otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "bernoulli")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        super().__init__(N, **kw)


class SparseNegativeBinomialGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab negative-binomial count GLM with an Erdos-Renyi
    prior (sigma_w = 0.003, mu_bias = -2 unless `net_kwargs` says
    otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "negative_binomial")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        kw = _merge_net_defaults(kw, sigma_w=0.003, mu_bias=-2.0)
        super().__init__(N, **kw)


class GaussianGLM(NonlinearAutoregressiveModel):
    """Dense linear-Gaussian GLM (sigma_w = 0.05, mu_bias = 0 unless
    `net_kwargs` says otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "gaussian")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        kw = _merge_net_defaults(kw, sigma_w=0.05, mu_bias=0.0)
        super().__init__(N, **kw)


class SparseGaussianGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab linear-Gaussian GLM with an Erdos-Renyi prior
    (sigma_w = 0.05, mu_bias = 0 unless `net_kwargs` says otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "gaussian")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        kw = _merge_net_defaults(kw, sigma_w=0.05, mu_bias=0.0)
        super().__init__(N, **kw)


class NegativeBinomialGLM(NonlinearAutoregressiveModel):
    """Dense negative-binomial count GLM (sigma_w = 0.003, mu_bias = -2
    unless `net_kwargs` says otherwise)."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "negative_binomial")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        kw = _merge_net_defaults(kw, sigma_w=0.003, mu_bias=-2.0)
        super().__init__(N, **kw)


class BinomialGLM(NonlinearAutoregressiveModel):
    """Dense Binomial GLM with the dense prior."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "binomial")
        kw.setdefault("network", "dense")
        kw.setdefault("spike_and_slab", False)
        super().__init__(N, **kw)
