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

from pyglm_tpu_torch.models.weights import (
    pack_weights, resample_dense, resample_spike_slab_tspace,
    sufficient_stats, unpack_weights,
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


def concat_datas(datas):
    """(Y, Xf, Xt) of the datasets concatenated along time."""
    if len(datas) == 1:
        return datas[0].Y, datas[0].Xf, datas[0].Xt
    return (torch.cat([d.Y for d in datas]), torch.cat([d.Xf for d in datas]),
            torch.cat([d.Xt for d in datas], dim=1))


def make_gibbs_sweep(obs, network, N: int, B: int, spike_slab: bool,
                     group: int | None = None, precision: str = "highest"):
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
    The datasets' ll caches are additive summaries (counts, scalar sums),
    so their sum stands for the concatenated data; it feeds the total
    log-likelihood and the NB collapsed-CRT r update.
    """

    def spike_slab_update(gens, w_full, hyp, datas, aux):
        Y, Xf, Xt = concat_datas(datas)
        psi = Xf @ w_full
        omega, kappa = obs.omega_kappa(gens.host, Y, psi, aux)
        Jg = None
        if all(d.Gg0 is not None for d in datas):
            # (Ng, GB(GB+1)/2, 1) / eta along the lane axis
            Jg = sum(d.Gg0 for d in datas) / aux["eta"]
        A, w_full, u, _ = resample_spike_slab_tspace(
            gens.device, Xt, omega, kappa, psi, w_full, hyp, B, group=group,
            precision=precision, host_generator=gens.host, Jg=Jg)
        # psi under the NEW weights, recovered without a second matmul.
        return A, w_full, Y, (kappa - u) / omega

    def dense_update(gens, w_full, hyp, datas, aux):
        if all(d.Gfull is not None for d in datas):
            inv_eta = 1.0 / aux["eta"]
            J = sum(d.Gfull for d in datas)[None] * inv_eta[:, None, None]
            h = sum(d.XtY for d in datas) * inv_eta
        else:
            J = h = 0.0
            for d in datas:
                omega, kappa = obs.omega_kappa(gens.host, d.Y, d.Xf @ w_full,
                                               aux)
                Jd, hd = sufficient_stats(d.Xf, omega, kappa)
                J, h = J + Jd, h + hd
        w_full = resample_dense(gens.device, J, h, hyp, B)
        Y, Xf, _ = concat_datas(datas)
        A = torch.ones((N, N), dtype=torch.float32, device=w_full.device)
        return A, w_full, Y, Xf @ w_full

    update = spike_slab_update if spike_slab else dense_update

    @fp32_matmul()
    def sweep(gens: Generators, state: GLMState, datas):
        w_full = pack_weights(state.A, state.W, state.b)
        hyp = network.edge_hypers(state.net, w_full.device)
        caches = [d.llc for d in datas]
        llc = (None if any(c is None for c in caches) else
               {k: sum(c[k] for c in caches) for k in caches[0]})
        A, w_full, Y, psi = update(gens, w_full, hyp, datas, state.aux)
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
