"""The cell's inputs from its seed: a ground-truth network drawn from the
configuration's truth prior, and T bins of spikes simulated from it, all
in plain PyTorch on the device.

A bin is one mat-vec on the running history: the L bins before t, read as
one flat (L N,) vector of a (L + T, N) buffer, against the (L N, N) matrix
of every lag's filter, plus the bin's bias and logistic noise drawn
beforehand; the spike is the sign. Two launches a bin.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gibbsbench.reference.design import cosine_basis


def sub_seeds(seed: int, n: int) -> list:
    """n independent 32-bit seeds from the cell's seed."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(n)]


def truth(cfg: dict, gen: torch.Generator, device) -> dict:
    """A, W (N, N, B) and b (N,) drawn from the truth prior of `cfg`."""
    t, N, B = cfg["truth"], cfg["N"], cfg["B"]
    f32 = dict(generator=gen, device=device)
    if t["network"] == "erdos_renyi":
        p = torch.full((N, N), float(t["rho"]), device=device)
    elif t["network"] == "latent_distance":
        pos = t["sigma_l"] * torch.randn((N, t["dim"]), **f32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        p = torch.sigmoid(torch.clamp(t["gamma"] - d2, -15.0, 15.0))
    else:
        raise ValueError(f"unknown truth network {t['network']!r}")
    A = (torch.rand((N, N), **f32) < p).to(torch.float32)
    W = t["mu_w"] + float(np.sqrt(t["sigma_w"])) * torch.randn(
        (N, N, B), **f32)
    b = t["mu_bias"] + t["sigma_bias"] * torch.randn((N,), **f32)
    return {"A": A, "W": W * A[:, :, None], "b": b}


@torch.no_grad()
def spikes(cfg: dict, tr: dict, gen: torch.Generator, device):
    """(T, N) float32 Bernoulli spikes of the truth `tr`."""
    N, B, L, T = cfg["N"], cfg["B"], cfg["L"], cfg["T"]
    basis = torch.as_tensor(cosine_basis(B, L), dtype=torch.float32,
                            device=device)
    Weff = tr["A"][:, :, None] * tr["W"]
    # Row r of a bin's window holds the spikes of lag d = L - r.
    MT = torch.einsum("rk,jnk->nrj", basis.flip(0), Weff).reshape(
        N, L * N).contiguous()
    u = torch.rand((T, N), generator=gen, device=device).clamp_(1e-7,
                                                               1 - 1e-7)
    c = tr["b"] + torch.log(u) - torch.log1p(-u)        # bias + noise
    Yp = torch.zeros((L + T, N), dtype=torch.float32, device=device)
    psi = torch.empty((N,), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    flat = Yp.reshape(-1)
    for t in range(T):
        torch.addmv(c[t], MT, flat[t * N:(t + L) * N], out=psi)
        torch.heaviside(psi, zero, out=Yp[t + L])
    return Yp[L:]


def make_inputs(cfg: dict, seed: int, device) -> dict:
    """The spikes of `seed` ("Y") and the seconds they took."""
    t0 = time.perf_counter()
    s_truth, s_spikes = sub_seeds(seed, 2)
    g = torch.Generator(device=device)
    tr = truth(cfg, g.manual_seed(s_truth), device)
    Y = spikes(cfg, tr, g.manual_seed(s_spikes), device)
    if Y.is_cuda:
        torch.cuda.synchronize()
    return {"Y": Y, "seconds": time.perf_counter() - t0}
