"""The Gibbs sweep, the log-likelihood and autoregressive generation
(PyTorch counterpart of ``pyglm_tpu/models/sweep.py``; ports the
spike-and-slab sweep).

PyTorch runs eagerly, so a sweep is a plain function
``sweep(generators, state, datas) -> (state, diagnostics)`` and generation
is a Python loop over time bins.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pyglm_tpu_torch.models.weights import (
    pack_weights, resample_spike_slab_tspace, unpack_weights,
)
from pyglm_tpu_torch.ops.linalg import chol_small, solve_lower_t_small
from pyglm_tpu_torch.utils.utils import fp32_matmul, logistic


class GLMData(NamedTuple):
    Y: torch.Tensor            # (T, N) observations
    Xf: torch.Tensor           # (T, P) design, last column = ones
    Xt: torch.Tensor | None    # (P, T) the same design, presyn-major rows
    llc: dict | None = None    # the family's ll_cache(Y), or None


class GLMState(NamedTuple):
    A: torch.Tensor     # (N, N) adjacency, A[pre, post] in {0, 1}
    W: torch.Tensor     # (N, N, B) weights (0 where A == 0)
    b: torch.Tensor     # (N,) biases
    aux: object         # family aux params: {"r": (N,)} for NB, else None
    net: object         # network-prior state (host tensors)


class Generators(NamedTuple):
    """A model's random streams: `device` draws tensors on the model's
    device; `host` (a CPU generator) draws the O(B^2) network updates and
    the Philox seeds of the kernels, so neither waits on the device."""
    device: torch.Generator
    host: torch.Generator


def make_gibbs_sweep(obs, network, N: int, B: int, spike_slab: bool,
                     group: int | None = None, precision: str = "highest"):
    """One Gibbs sweep (the JAX package's move order):
      1. psi = Xf w;  (omega, kappa) from the family: PG(1, psi) by K1 for
         Bernoulli, PG(y + r, psi) by K4 for NB
      2. (A, W, bias) by the collapsed spike-and-slab update at
         `precision` (models/weights.py: K2 + K3 or K6 + K3); "sr" draws
         K2's rounding seeds from the host generator
      3. observation aux, then the network hyperparameters given (A, W)
    Returns (new_state, {"log_likelihood", "n_edges"}), both 0-d tensors,
    plus "hmc_accept" when the network state carries one.
    The datasets' ll caches are additive summaries (counts, scalar sums),
    so their sum stands for the concatenated data; it feeds the total
    log-likelihood and the NB collapsed-CRT r update.
    """
    if not spike_slab:
        raise NotImplementedError(
            "the dense (spike_and_slab=False) sweep is not ported to "
            "pyglm_tpu_torch yet (ROADMAP.md Queue A, item 8)")

    @fp32_matmul()
    def sweep(gens: Generators, state: GLMState, datas):
        w_full = pack_weights(state.A, state.W, state.b)
        dev = w_full.device
        hyp = network.edge_hypers(state.net, dev)
        if len(datas) == 1:
            Y, Xf, Xt = datas[0].Y, datas[0].Xf, datas[0].Xt
        else:       # datasets concatenate along time
            Y = torch.cat([d.Y for d in datas])
            Xf = torch.cat([d.Xf for d in datas])
            Xt = torch.cat([d.Xt for d in datas], dim=1)
        caches = [d.llc for d in datas]
        llc = (None if any(c is None for c in caches) else
               {k: sum(c[k] for c in caches) for k in caches[0]})
        psi = Xf @ w_full
        omega, kappa = obs.omega_kappa(gens.host, Y, psi, state.aux)
        A, w_full, u, _ = resample_spike_slab_tspace(
            gens.device, Xt, omega, kappa, psi, w_full, hyp, B, group=group,
            precision=precision, host_generator=gens.host)
        # psi under the NEW weights, recovered without a second matmul.
        psi = (kappa - u) / omega
        W, b = unpack_weights(w_full, N, B)
        aux = obs.resample_aux(gens.host, state.aux, Y, psi, cache=llc)
        net = network.resample(gens, state.net, A, W)
        ll = obs.log_likelihood_sum(Y, psi, aux, llc)
        diag = {"log_likelihood": ll, "n_edges": A.sum()}
        if hasattr(net, "hmc_accept"):
            diag["hmc_accept"] = net.hmc_accept
        return GLMState(A, W, b, aux, net), diag

    return sweep


def make_log_likelihood(obs, N: int, B: int):
    @fp32_matmul()
    def log_likelihood(state: GLMState, data: GLMData):
        psi = data.Xf @ pack_weights(state.A, state.W, state.b)
        return obs.log_likelihood_sum(data.Y, psi, state.aux)
    return log_likelihood


def make_generator(obs, N: int, B: int):
    """Autoregressive forward simulation from silence: a loop over time bins
    that keeps the last L bins of output in a ring. The family's
    psi-independent noise for all T bins (Bernoulli's uniforms, NB's
    Gamma(r) factors) is drawn before the loop, so a bin costs one draw
    that needs no host sync. ``uniforms`` (T, N), if given, replaces a
    Bernoulli family's uniforms (for reproducing a reference run)."""

    @fp32_matmul()
    def generate(generator: torch.Generator, state: GLMState, basis, T: int,
                 uniforms=None):
        dev = state.b.device
        basis = torch.as_tensor(basis, dtype=torch.float32, device=dev)
        L = basis.shape[0]
        basis_rev = basis.flip(0)                                # (L, B)
        W2 = (state.A[:, :, None] * state.W).permute(0, 2, 1).reshape(
            N * B, N)                                            # (N*B, N)
        # Each bin is written twice, L rows apart, so rows pos+1 .. pos+L
        # are always the last L bins in time order.
        ring = torch.zeros((2 * L, N), dtype=torch.float32, device=dev)
        noise = (obs.sample_noise(generator, (T, N), state.aux)
                 if uniforms is None else uniforms)
        Y = torch.empty((T, N), dtype=torch.float32, device=dev)
        psi = torch.empty((T, N), dtype=torch.float32, device=dev)
        pos = 0
        for t in range(T):
            F = ring[pos + 1:pos + 1 + L].T @ basis_rev          # (N, B)
            psi[t] = state.b + F.reshape(-1) @ W2
            y = obs.sample(generator, psi[t], state.aux,
                           None if noise is None else noise[t])
            Y[t] = y
            pos = (pos + 1) % L
            ring[pos] = y
            ring[pos + L] = y
        return Y, psi

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
