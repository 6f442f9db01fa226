"""User-facing model classes (PyTorch counterpart of
``pyglm_tpu/models/glm.py``; this slice ports the spike-and-slab Bernoulli
model with an Erdos-Renyi prior).

The class is a thin stateful shell: the chain state is a ``GLMState`` of
tensors on the model's `device`, and one ``resample_model`` call is one
Gibbs sweep (models/sweep.py). Randomness comes from the model's own
generators, seeded from `seed`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyglm_tpu_torch.models.networks import make_network
from pyglm_tpu_torch.models.observations import make_observation
from pyglm_tpu_torch.models.sweep import (
    Generators, GLMData, GLMState, init_state_from_prior, make_generator,
    make_gibbs_sweep, make_log_likelihood,
)
from pyglm_tpu_torch.models.weights import _auto_group
from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix

# On the card "high" and "highest" both run the fp32 kernels.
_PRECISIONS = ("high", "highest")


def _as_f32(Y, device) -> torch.Tensor:
    """A float32 tensor on `device` from a tensor or an array-like."""
    if isinstance(Y, torch.Tensor):
        return Y.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(Y), dtype=torch.float32, device=device)


class NonlinearAutoregressiveModel:
    """Fully-Bayesian network GLM of spike trains (Gibbs inference).

    psi[t, n] = b[n] + sum_j A[j,n] sum_k W[j,n,k] (Y[:,j] * basis_k)(t-1)
    Y[t, n] ~ observation(link(psi[t, n])),  (A, W) ~ network prior.

    Args:
      N: number of neurons.
      B, L: basis dimension / filter length (ignored if `basis` given).
      basis: optional (L, B) filter matrix.
      observation, network: family / prior names or config objects. This
        slice runs 'bernoulli' with 'erdos_renyi' and spike_and_slab=True.
      seed: seed of this model's generators.
      precision: 'high' (default) or 'highest', both fp32 on the card.
      group: presyn neurons per spike-and-slab group (default: the divisor
        of N nearest 8 with group*B % 8 == 0, i.e. 8 at N = 200, B = 4).
      device: where the data, the state and the kernels live.
    """

    def __init__(self, N: int, B: int = 4, L: int = 10, basis=None,
                 observation="bernoulli", network="dense",
                 spike_and_slab: bool = False, seed: int = 0,
                 precision: str = "high", group: int | None = None,
                 device="cpu", obs_kwargs: Optional[dict] = None,
                 net_kwargs: Optional[dict] = None):
        if precision not in _PRECISIONS:
            raise NotImplementedError(
                f"precision={precision!r} is not ported to pyglm_tpu_torch "
                f"yet: only {_PRECISIONS} (ROADMAP.md Queue A, precision "
                f"modes of K2)")
        if basis is None:
            basis = cosine_basis(B=B, L=L)
        basis = np.asarray(basis, np.float32)
        self.N = N
        self.L, self.B = basis.shape
        self.basis = basis
        self.spike_and_slab = bool(spike_and_slab)
        self.device = torch.device(device)
        self.observation = (make_observation(observation, **(obs_kwargs or {}))
                            if isinstance(observation, str) else observation)
        self.network = (make_network(network, N=N, B=self.B,
                                     **(net_kwargs or {}))
                        if isinstance(network, str) else network)
        self.group = _auto_group(N, self.B) if group is None else group

        dev_gen = torch.Generator(device=self.device)
        dev_gen.manual_seed(seed)
        host_gen = torch.Generator()
        host_gen.manual_seed(seed + 0x5EED)
        self.generators = Generators(dev_gen, host_gen)

        self._sweep = make_gibbs_sweep(self.observation, self.network, N,
                                       self.B, self.spike_and_slab,
                                       group=self.group)
        self._loglik = make_log_likelihood(self.observation, N, self.B)
        self._generate = make_generator(self.observation, N, self.B)
        self.state: GLMState = init_state_from_prior(
            self.generators, self.observation, self.network, N, self.B,
            self.spike_and_slab, self.device)
        self.datas: list[GLMData] = []

    @property
    def P(self) -> int:
        return self.N * self.B + 1

    def add_data(self, Y) -> None:
        """Register a (T, N) spike matrix: builds the design (T, P) and its
        transpose (P, T) on the model's device."""
        Y = _as_f32(Y, self.device)
        if Y.ndim != 2 or Y.shape[1] != self.N:
            raise ValueError(f"expected (T, {self.N}) data, got "
                             f"{tuple(Y.shape)}")
        Xf = design_matrix(Y, self.basis)
        self.datas.append(GLMData(Y=Y, Xf=Xf, Xt=Xf.T.contiguous()))

    def generate(self, T: int, keep: bool = True):
        """Sample a (T, N) spike train from the current parameters."""
        Y, _ = self._generate(self.generators.device, self.state,
                              self.basis, T)
        if keep:
            self.add_data(Y)
        return Y.cpu().numpy()

    def resample_model(self):
        """One Gibbs sweep over weights, adjacency, aux and network."""
        if not self.datas:
            raise RuntimeError("call add_data() or generate(keep=True) first")
        self.state, diag = self._sweep(self.generators, self.state,
                                       tuple(self.datas))
        return {k: float(v) for k, v in diag.items()}

    def log_likelihood(self, data=None) -> float:
        """Total log-likelihood of the registered data (or of a (T, N) Y)."""
        if data is None:
            return float(sum(self._loglik(self.state, d)
                             for d in self.datas))
        Y = _as_f32(data, self.device)
        d = GLMData(Y=Y, Xf=design_matrix(Y, self.basis), Xt=None)
        return float(self._loglik(self.state, d))

    @property
    def A(self) -> np.ndarray:
        """(N_pre, N_post) adjacency sample."""
        return self.state.A.cpu().numpy()

    @property
    def W(self) -> np.ndarray:
        """(N_pre, N_post, B) weight sample (zero where A == 0)."""
        return self.state.W.cpu().numpy()

    @property
    def bias(self) -> np.ndarray:
        return self.state.b.cpu().numpy()

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
        N, B = self.N, self.B
        shapes = {"A": (0, N, N), "W": (0, N, N, B), "bias": (0, N),
                  "lls": (0,)}
        return {k: (np.asarray(v, np.float32) if v
                    else np.zeros(shapes[k], np.float32))
                for k, v in samples.items()}


GLM = NonlinearAutoregressiveModel


class SparseBernoulliGLM(NonlinearAutoregressiveModel):
    """Spike-and-slab Bernoulli GLM with an Erdos-Renyi prior."""

    def __init__(self, N, **kw):
        kw.setdefault("observation", "bernoulli")
        kw.setdefault("network", "erdos_renyi")
        kw.setdefault("spike_and_slab", True)
        super().__init__(N, **kw)
