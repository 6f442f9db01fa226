"""Kernel K3 (the spike-and-slab edge scan, ``csrc/ss_edge_scan.cu``) on the
CPU, where the kernel itself cannot run: its lane-tile plan
(``ops/ss_cuda.py::edge_scan_plan``) against the 227 KB of shared memory a
block may take, and its order of work written out in PyTorch (a parallel
prologue over all edges, then a serial scan on a residual that each edge
updates by rank B) against the plain version, which
tests/test_torch_spike_slab.py holds against the JAX package."""
import pytest
import torch

from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops.linalg import (
    chol_small, solve_lower_small, solve_lower_t_small)
from pyglm_tpu_torch.ops.ss_cuda import (
    _K3_SMEM, _K3_TILES, edge_scan_plan, edge_scan_smem_bytes,
    ss_edge_scan_plain, ss_group_pass_plain, unpack_gram)


@pytest.mark.parametrize("B", range(1, 9))
def test_plan_fits_every_group(B):
    """For every group K2 and K6 take (GB <= 64) at every lane count, the
    plan's tile fits, and it is the widest that fits and leaves no SM
    without a block, else 8 lanes."""
    for G in range(1, 64 // B + 1):
        for N in (1, 7, 200, 1000, 2112, 4000, 4001, 20000):
            tile = edge_scan_plan(G, B, N)
            assert tile in _K3_TILES
            assert edge_scan_smem_bytes(G, B, tile) <= _K3_SMEM
            assert edge_scan_smem_bytes(G, B, 16) <= _K3_SMEM
            full = [t for t in _K3_TILES
                    if edge_scan_smem_bytes(G, B, t) <= _K3_SMEM
                    and -(-N // t) >= 132]
            assert tile == (full[0] if full else 8)


@pytest.mark.parametrize("G,B", [(17, 4), (9, 8), (65, 1)])
def test_plan_raises_past_the_limit(G, B):
    """A group past K2's and K6's GB = 64 raises, as theirs do; one edge
    fewer is taken."""
    with pytest.raises(ValueError):
        edge_scan_plan(G, B, 200)
    assert edge_scan_plan(G - 1, B, 200) == 8


def test_auto_group_never_reaches_the_limit():
    """Every group ``_auto_group`` gives that K2 and K6 take (GB <= 64),
    K3 takes too; the groups past it raise here as they do there."""
    for B in range(1, 9):
        for n_pre in range(1, 513):
            G = tw._auto_group(n_pre, B)
            if G * B <= 64:
                assert edge_scan_plan(G, B, 4000) in _K3_TILES
            else:
                with pytest.raises(ValueError):
                    edge_scan_plan(G, B, 4000)


def test_plan_at_the_main_paths():
    """The flagship's group (G = 8, B = 4, 200 lanes) takes 8 lanes: 25
    blocks of 23.2 KB; config 5's (G = 10, B = 4, 4000 lanes) 16 lanes: 250
    blocks of 68.1 KB (32 lanes would leave 7 of 132 SMs idle)."""
    assert edge_scan_plan(8, 4, 200) == 8
    assert edge_scan_plan(10, 4, 4000) == 16
    assert edge_scan_smem_bytes(8, 4, 8) == 23168
    assert edge_scan_smem_bytes(10, 4, 16) == 68096


def _residual_scan(jgg, m0, w, mu, lam, lrho, u_a, eps):
    """csrc/ss_edge_scan.cu's order of work: per edge i, a prologue that
    needs no other edge (the two Choleskys and log-determinants, Lam0 mu0,
    Lp^{-T} eps and the residual r_i = M0_i + J_ii w_i + Lam0 mu0); then the
    serial scan, which solves z = Lp^{-1} r_i, draws the edge and applies
    r_q -= J[q, i] dW_i to the later edges' rows. Updates w in place and
    returns (dW, a)."""
    G, N, B = mu.shape
    GB = G * B
    J = unpack_gram(jgg, GB)                               # (N, GB, GB)
    r, w_old = m0.clone(), w.clone()
    Lp, E, C = [], [], []
    for i in range(G):
        sl = slice(i * B, (i + 1) * B)
        Jii = J[:, sl, sl]
        t = torch.einsum("nbc,nc->nb", lam[i], mu[i])
        r[sl] = (r[sl].T + torch.einsum("nbc,cn->nb", Jii, w_old[sl])
                 + t).T
        L0, Lpi = chol_small(lam[i]), chol_small(lam[i] + Jii)
        ld0 = torch.log(torch.diagonal(L0, dim1=-2, dim2=-1)).sum(-1)
        ldp = torch.log(torch.diagonal(Lpi, dim1=-2, dim2=-1)).sum(-1)
        Lp.append(Lpi)
        E.append(solve_lower_t_small(Lpi, eps[i]))
        C.append(lrho[i] - 0.5 * (mu[i] * t).sum(-1) + ld0 - ldp)
    dW = torch.zeros_like(m0)
    a = torch.empty((G, N))
    for i in range(G):
        sl = slice(i * B, (i + 1) * B)
        z = solve_lower_small(Lp[i], r[sl].T)
        log_odds = C[i] + 0.5 * (z * z).sum(-1)
        act = u_a[i] < 1.0 / (1.0 + torch.exp(-log_odds))
        wn = torch.where(act[:, None], solve_lower_t_small(Lp[i], z) + E[i],
                         torch.zeros_like(z))
        dW[sl] = wn.T - w_old[sl]
        w[sl] = wn.T
        a[i] = act.float()
        r[(i + 1) * B:] -= torch.einsum("nqc,cn->qn",
                                        J[:, (i + 1) * B:, sl], dW[sl])
    return dW, a


@pytest.mark.parametrize("G,B,N", [(1, 4, 30), (3, 1, 50), (3, 3, 50),
                                   (3, 8, 40), (10, 4, 61)])
def test_residual_scan_matches_plain(G, B, N):
    """The same inputs and noise (the card test's recipe, at fewer lanes)
    through the kernel's order of work and the plain version: A identical,
    W and dW within 1e-4."""
    gen = torch.Generator().manual_seed(100 * G + 10 * B + N)
    GB, Tn = G * B, 2000
    X = (torch.rand((GB, Tn), generator=gen) < 0.3).float()
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen)
    u = 0.05 * torch.randn((Tn, N), generator=gen)
    m0, jgg, _ = ss_group_pass_plain(None, X, om, u, None)
    M = torch.randn((G, N, B, B), generator=gen)
    lam = M @ M.transpose(-1, -2) / B + torch.eye(B)
    mu = 0.1 * torch.randn((G, N, B), generator=gen)
    lrho = torch.full((G, N), -1.0)
    w0 = 0.1 * torch.randn((GB, N), generator=gen)
    u_a = torch.rand((G, N), generator=gen)
    eps = torch.randn((G, N, B), generator=gen)
    wk, wp = w0.clone(), w0.clone()
    dk, ak = _residual_scan(jgg, m0, wk, mu, lam, lrho, u_a, eps)
    dp, ap = ss_edge_scan_plain(jgg, m0, wp, mu, lam, lrho, u_a, eps)
    assert torch.equal(ak, ap) and 0 < float(ak.sum()) < ak.numel()
    assert float((wk - wp).abs().max()) <= 1e-4
    assert float((dk - dp).abs().max()) <= 1e-4
