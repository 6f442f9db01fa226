"""The host side of K2's streaming pass (``csrc/ss_group_pass.cu``,
``stream_pass_kernel``: the scatter u -= omega (X_p^T dW) and the gather M0
= X_g u in one pass over u), on the CPU. The kernel itself is held against
its plain version on the card (tests/test_torch_cuda.py).

- The chunk, ring and lane constants of ``ops/ss_cuda.py`` equal the kernel
  source's (and the lanes a thread serves, its ``lanes_per_thread``), and
  ``stream_smem_bytes`` is the launcher's shared memory at the fp32 omega.
- ``stream_pass_plan`` covers every step of T and every lane exactly once,
  with no empty split or lane tile, for GB 1..64.
- At the main paths' shapes (the flagship group, config 4, the two mesh
  shapes and config 5's width) the plan fits a block's shared memory and
  the grid's limits, fills at most one wave at the residency it assumes,
  and keeps the M0 partials at most an eighth of u's bytes.
- ``ss_group_pass_plain``'s u and M0 match the JAX package's per-group
  pass ``ss_group_pass_pallas`` (run in the TPU interpret mode on the CPU)
  at the first, a middle and the epilogue group.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pyglm_tpu.ops.ss_pallas import ss_group_pass_pallas, ss_group_pass_tc
from pyglm_tpu_torch.ops import ss_cuda
from pyglm_tpu_torch.ops.ss_cuda import (
    STREAM_CHUNK, STREAM_MAX_LANES, STREAM_STAGES, ss_group_pass_plain,
    stream_lanes_per_thread, stream_pass_plan, stream_rows,
    stream_smem_bytes)

torch.set_num_threads(1)

CSRC = Path(ss_cuda.__file__).resolve().parents[1] / "csrc"
_BLOCK_SMEM, _SM_SMEM, _SMS = 232448, 233472, 132
GBS = [1, 4, 12, 16, 17, 32, 33, 40, 64]
# (T, N): the flagship group, config 4, the mesh-fused loop's rank shapes
# on (2, 1) and (1, 2), config 5's width, and ragged small shapes.
MAIN_SHAPES = [(100_000, 200), (40_000, 100), (50_000, 200), (100_000, 100),
               (20_000, 4000)]
SMALL_SHAPES = [(1, 1), (40, 7), (3001, 13), (3001, 70), (4099, 257),
                (2000, 16), (600, 1000)]


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "ss_group_pass.cu").read_text())
    assert m, name
    return int(m.group(1))


def test_constants_match_the_kernel_source():
    assert _constant("kMaxLanes") == STREAM_MAX_LANES
    assert _constant("kCh") == STREAM_CHUNK
    assert _constant("kStages") == STREAM_STAGES
    assert _constant("kMaxGB") == 64
    src = (CSRC / "ss_group_pass.cu").read_text()
    assert "return R <= 32 ? 2 : 1;" in src
    assert [stream_lanes_per_thread(GB) for GB in (1, 16, 17, 32, 33, 64)
            ] == [2, 2, 2, 2, 1, 1]
    # stream_smem_bytes<R, float>(W) = kStages kCh (4 * 2 R + (4 + 4) W).
    for GB in GBS:
        R = stream_rows(GB)
        assert R >= GB and R in (16, 32, 64)
        for W in (32, 96, 224, 256):
            assert stream_smem_bytes(GB, W) == (
                STREAM_STAGES * STREAM_CHUNK * (4 * 2 * R + 8 * W))


@pytest.mark.parametrize("GB", GBS)
@pytest.mark.parametrize("T,N", MAIN_SHAPES + SMALL_SHAPES)
def test_plan_covers_every_step_and_lane_once(T, N, GB):
    n_split, steps, lanes = stream_pass_plan(T, N, GB)
    assert n_split >= 1 and steps % STREAM_CHUNK == 0
    # The launcher's own checks.
    assert (n_split - 1) * steps < T <= n_split * steps
    L = stream_lanes_per_thread(GB)
    assert lanes % (32 * L) == 0 and 32 * L <= lanes <= STREAM_MAX_LANES
    cover_t = np.zeros(T, np.int64)
    for s in range(n_split):
        lo, hi = s * steps, min(T, (s + 1) * steps)
        assert hi > lo
        cover_t[lo:hi] += 1
    assert (cover_t == 1).all()
    tiles = -(-N // lanes)
    cover_n = np.zeros(N, np.int64)
    for j in range(tiles):
        lo, hi = j * lanes, min(N, (j + 1) * lanes)
        assert hi > lo
        cover_n[lo:hi] += 1
    assert (cover_n == 1).all()
    # The fewest tiles of at most STREAM_MAX_LANES lanes.
    assert tiles == -(-N // STREAM_MAX_LANES)


@pytest.mark.parametrize("GB", range(1, 65))
def test_plan_fits_the_card_at_the_main_shapes(GB):
    for T, N in MAIN_SHAPES:
        n_split, steps, lanes = stream_pass_plan(T, N, GB)
        tiles = -(-N // lanes)
        smem = stream_smem_bytes(GB, lanes)
        assert smem <= _BLOCK_SMEM
        assert stream_smem_bytes(GB, STREAM_MAX_LANES) <= _BLOCK_SMEM
        threads = lanes // stream_lanes_per_thread(GB)
        per_sm = min(65536 // (256 * threads), _SM_SMEM // (smem + 1024),
                     2048 // threads)
        assert per_sm >= 1
        assert tiles <= 65535 and n_split < 2 ** 31
        assert n_split * tiles <= max(per_sm * _SMS, tiles)
        if n_split > 1:
            assert n_split * GB * N <= 2 * T * N / 8
            assert steps >= 4 * GB


def test_plan_at_the_flagship_group():
    """One wave of 2 x 132 blocks of 256 lanes (128 threads of 2 lanes; 56
    idle lanes)."""
    assert stream_pass_plan(100_000, 200, 32) == (261, 384, 256)
    assert stream_pass_plan(100_000, 200, 32, n_sm=66) == (131, 768, 256)


def _jax_pass(xp, xg, om, u, dw, T):
    """ss_group_pass_pallas on numpy inputs, padded as its callers pad
    them (T to its chunk, lanes to 128), in the TPU interpret mode; the
    fp32 mode of its Gram ("bf16x3"). Returns (u_new, M0) at (T, N)."""
    N = u.shape[1]
    tc = ss_group_pass_tc(T, 512)
    pad_t, pad_n = -(-T // tc) * tc - T, 128 - N

    def pad(a):
        return jnp.pad(jnp.asarray(a), ((0, pad_t), (0, pad_n)))
    with pltpu.force_tpu_interpret_mode():
        u_new, m0, _ = ss_group_pass_pallas(
            jnp.asarray(xp), jnp.asarray(xg), pad(om), pad(u),
            jnp.pad(jnp.asarray(dw), ((0, 0), (0, pad_n))), T, t_chunk=512,
            gram="bf16x3")
    return np.asarray(u_new)[:T, :N], np.asarray(m0)[:, :N]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("GB", [4, 12, 32, 64])
@pytest.mark.parametrize("case", ["first", "middle", "epilogue"])
def test_plain_matches_the_jax_group_pass(case, GB):
    """u and M0 of K2's plain version against the JAX package's per-group
    pass on the same numpy inputs (T = 1000: two chunks of 512, the second
    ragged; 13 lanes). The first group has no scatter (the JAX pass gets a
    zero X_p and dW, as its fused kernel has dW = 0 at g = 0); the epilogue
    has no gather (the JAX pass gets a zero X_g, and only u is compared).
    Tolerance 1e-5 of the largest value: the JAX pass forms its products
    as bf16x3 (_mm3, _mm3_t: each product to ~2^-16 relative, its dropped
    lo x lo term), the plain version in fp32."""
    T, N = 1000, 13
    rng = np.random.default_rng(GB + 100 * len(case))
    X = (rng.random((2 * GB, T)) * (rng.random((2 * GB, T)) < 0.5)
         ).astype(np.float32)
    xp, xg = X[:GB], X[GB:]
    om = (0.05 + 0.2 * rng.random((T, N))).astype(np.float32)
    u = rng.standard_normal((T, N)).astype(np.float32)
    dw = (0.1 * rng.standard_normal((GB, N))).astype(np.float32)
    zeros = np.zeros_like(xp)
    u_j, m0_j = _jax_pass(zeros if case == "first" else xp,
                          zeros if case == "epilogue" else xg, om, u,
                          np.zeros_like(dw) if case == "first" else dw, T)
    u_t = torch.from_numpy(u.copy())
    m0_t, _, _ = ss_group_pass_plain(
        None if case == "first" else torch.from_numpy(xp),
        None if case == "epilogue" else torch.from_numpy(xg),
        torch.from_numpy(om), u_t,
        None if case == "first" else torch.from_numpy(dw))
    assert _rel(u_t.numpy(), u_j) <= 1e-5
    if case == "epilogue":
        assert m0_t is None
    else:
        assert _rel(m0_t.numpy(), m0_j) <= 1e-5
