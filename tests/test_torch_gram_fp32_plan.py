"""The split plan of K6's fp32 body ("highest"),
``ops/gram_cuda.py::fp32_split_plan``: the kernel's limits, every pair row,
lane and time step served by exactly one block, and the decomposition it
describes (80 x 200 tiles, T ranges, 16-step stages, 512-step folds,
partials summed in order) giving the plain Gram."""
import pytest
import torch

from pyglm_tpu_torch.ops.gram_cuda import (
    FP32_FOLD, FP32_NX, FP32_RY, FP32_STAGE, fp32_smem_bytes,
    fp32_split_plan, group_gram_blocks_plain)
from pyglm_tpu_torch.ops.ss_cuda import pair_index


def _check_plan(GB, N, T, Ng):
    npair = GB * (GB + 1) // 2
    ry, nx = FP32_RY, FP32_NX
    n_split, steps = fp32_split_plan(GB, N, T, Ng)
    # csrc/group_gram.cu::group_gram_fp32_launch's limits.
    assert ry * nx <= 256 and 1 <= n_split <= 64
    # Two blocks an SM (kFMaxSmem: half of 228 KB less 1 KB a block).
    assert fp32_smem_bytes(GB) <= 115712
    assert steps % FP32_FOLD == 0 and steps % FP32_STAGE == 0
    assert (n_split - 1) * steps < T <= n_split * steps
    n_rt, n_lt = -(-npair // (8 * ry)), -(-N // (8 * nx))
    assert n_rt <= 65535 and Ng <= 65535 and n_lt * n_split <= 65535
    # Every pair row, lane and step in exactly one tile / range.
    rows = torch.zeros(npair, dtype=torch.int32)
    for r in range(n_rt):
        rows[8 * ry * r:8 * ry * (r + 1)] += 1
    lanes = torch.zeros(N, dtype=torch.int32)
    for lt in range(n_lt):
        lanes[8 * nx * lt:8 * nx * (lt + 1)] += 1
    steps_seen = torch.zeros(T, dtype=torch.int32)
    for s in range(n_split):
        steps_seen[s * steps:(s + 1) * steps] += 1
    assert bool((rows == 1).all() and (lanes == 1).all()
                and (steps_seen == 1).all())
    return n_split, steps


@pytest.mark.parametrize("T", [1, 40, 3001, 100_000])
@pytest.mark.parametrize("N", [1, 70, 200, 4001])
@pytest.mark.parametrize("GB", [1, 4, 32, 40, 64])
def test_plan_serves_every_shape(GB, N, T):
    _check_plan(GB, N, T, 25)


def test_plan_at_the_main_paths():
    """The flagship's "highest" call (25 groups of 528 pairs, 200 lanes, T
    = 1e5: 175 tiles of 80 x 200) takes 3 splits: 525 blocks, 2 waves of
    2 x 132; config 5 (50 groups of 820 pairs, 4000 lanes, T = 2e4: 11000
    tiles) and any grid of one wave or more (264 tiles) runs unsplit; two
    groups at 250 lanes (44 tiles) split T in 6, one wave of 264 blocks."""
    assert _check_plan(32, 200, 100_000, 25) == (3, 33792)
    assert _check_plan(40, 4000, 20_000, 50) == (1, 20480)
    assert _check_plan(40, 250, 20_000, 2) == (6, 3584)
    assert _check_plan(64, 128, 20_000, 25) == (1, 20480)


def _emulate(Xt, omega, B, G):
    """The fp32 body's decomposition in PyTorch: per block (group, pair
    tile, lane tile, T range) the sum over 16-step stages, folded into a
    second sum every 512 steps; the ranges' partials summed in order."""
    T, N = omega.shape
    GB = G * B
    Ng = (Xt.shape[0] - 1) // GB
    p, q = pair_index(GB, Xt.device)
    npair = p.numel()
    n_split, steps = fp32_split_plan(GB, N, T, Ng)
    rt, nt = 8 * FP32_RY, 8 * FP32_NX
    out = torch.zeros((Ng, npair, N))
    for g in range(Ng):
        Z = Xt[g * GB:(g + 1) * GB][p] * Xt[g * GB:(g + 1) * GB][q]
        for r0 in range(0, npair, rt):
            for l0 in range(0, N, nt):
                for s in range(n_split):
                    acc = torch.zeros_like(out[g, r0:r0 + rt, l0:l0 + nt])
                    fold = torch.zeros_like(acc)
                    for i, t0 in enumerate(range(s * steps,
                                                 min(T, (s + 1) * steps),
                                                 FP32_STAGE)):
                        t1 = min(T, t0 + FP32_STAGE)
                        acc += (Z[r0:r0 + rt, t0:t1]
                                @ omega[t0:t1, l0:l0 + nt])
                        if (i + 1) % (FP32_FOLD // FP32_STAGE) == 0:
                            fold, acc = fold + acc, torch.zeros_like(acc)
                    out[g, r0:r0 + rt, l0:l0 + nt] += fold + acc
    return out


@pytest.mark.parametrize("T,N_pre,G,lanes", [(3001, 12, 3, 70),
                                             (1100, 8, 8, 230),
                                             (40, 6, 3, 9)])
def test_decomposition_gives_the_plain_gram(T, N_pre, G, lanes):
    gen = torch.Generator().manual_seed(T)
    B = 4
    Xt = torch.rand((N_pre * B + 1, T), generator=gen) * (
        torch.rand((N_pre * B + 1, T), generator=gen) < 0.3)
    om = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen)
    got = _emulate(Xt, om, B, G)
    ref = group_gram_blocks_plain(Xt, om, B, G, precision="highest")
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
