"""The host side of the 3xTF32 Gram body that K2 and K6 run at precision
"high" (the TF32 mode of ``csrc/gram_wgmma.cuh``, ``gram_tile_tf32``), on
the CPU. The kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py).

- The tile and stage constants of ``ops/ss_cuda.py`` equal the kernel
  sources' (the pair tables and the split plan are laid out at them).
- pair_tile_plan at the TF32 tile widths (K6's 120 rows, K2's 136) covers
  each packed pair once, for GB 1..64.
- gram_split_plan at K2's "high" tile and 32-step stage: the splits start
  on stages, cover [0, T) once with none empty, fill at most one wave, and
  keep at least 8 stages each where T allows more than one split.
- The block's shared memory stays within the 232,448 bytes a block may
  take, for every GB up to 64.
- tf32_split: hi is the TF32 value nearest x (ties away from zero), lo is
  x - hi cut toward zero to TF32.
- A numpy emulation of the body's arithmetic (hi rounded to TF32, lo read
  as TF32, per 8-step slice the products lo.hi, hi.lo, hi.hi, small terms
  first, each added to the fp32 accumulator with one guard bit and cut
  toward zero, the accumulator folded into a second sum by Fast2Sum every
  TF32_FOLD_STEPS steps) stays within 2x the fp32 plain version's distance
  from a float64 Gram, on the flagship's kind of inputs. The cut with one
  guard bit reproduces the H100's drift without folds (7.6e-5 relative at
  T = 2e4, PERF.md); the emulation without folds drifts that far too.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyglm_tpu_torch.ops import ss_cuda
from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.ops.gram_cuda import tf32_split
from pyglm_tpu_torch.ops.ss_cuda import (
    K2_TF32_PAIR_TILE, LANE_TILE, TF32_FOLD_STEPS, TF32_PAIR_TILE,
    TF32_STAGE_STEPS, gram_split_plan, pair_index, pair_tile_plan,
    tf32_smem_bytes)

torch.set_num_threads(1)

CSRC = Path(ss_cuda.__file__).resolve().parents[1] / "csrc"


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / source).read_text())
    assert m, (source, name)
    return int(m.group(1))


def test_constants_match_the_kernel_sources():
    assert _constant("group_gram.cu", "kTf32NP") == TF32_PAIR_TILE
    assert _constant("ss_group_pass.cu", "kK2Tf32NP") == K2_TF32_PAIR_TILE
    assert _constant("gram_wgmma.cuh", "kKS3") == TF32_STAGE_STEPS
    assert _constant("gram_wgmma.cuh", "kLT") == LANE_TILE
    assert (_constant("gram_wgmma.cuh", "kFold3") * TF32_STAGE_STEPS
            == TF32_FOLD_STEPS)
    assert _constant("gram_wgmma.cuh", "kStages3") == ss_cuda._RING_STAGES
    # wgmma's N is a multiple of 8 up to 256.
    for tile in (TF32_PAIR_TILE, K2_TF32_PAIR_TILE):
        assert tile % 8 == 0 and tile <= 256


@pytest.mark.parametrize("tile", [TF32_PAIR_TILE, K2_TF32_PAIR_TILE])
@pytest.mark.parametrize("GB", range(1, 65))
def test_tf32_pair_tile_plan_covers_each_pair_once(GB, tile):
    """Every packed pair row once, in order, the padding (0xFFFF) only past
    the last pair, in the fewest tiles of `tile` rows."""
    table = pair_tile_plan(GB, tile=tile)
    p, q = pair_index(GB)
    npair = p.numel()
    assert table.dtype == torch.int16
    assert table.numel() == -(-npair // tile) * tile
    e = table.to(torch.int32) & 0xFFFF
    assert bool((e[npair:] == 0xFFFF).all())
    assert torch.equal(e[:npair] & 0xFF, p.to(torch.int32))
    assert torch.equal(e[:npair] >> 8, q.to(torch.int32))


def test_tf32_tiles_at_the_main_paths_groups():
    """K6's GB = 40 (820 pairs) in 7 tiles of 120 (2.4% padding), K2's
    GB = 32 (528 pairs) in 4 tiles of 136 (3%)."""
    assert pair_tile_plan(40, tile=TF32_PAIR_TILE).numel() == 7 * 120
    assert pair_tile_plan(32, tile=K2_TF32_PAIR_TILE).numel() == 4 * 136


@pytest.mark.parametrize("GB", [1, 4, 32, 40, 64])
@pytest.mark.parametrize("N", [7, 200, 4001])
@pytest.mark.parametrize("T", [1, 31, 32, 3001, 4099, 100_000])
def test_tf32_gram_split_plan(T, N, GB):
    n_sm, stage = 132, TF32_STAGE_STEPS
    n_split, steps = gram_split_plan(T, N, GB, n_sm, K2_TF32_PAIR_TILE,
                                     stage)
    npair = GB * (GB + 1) // 2
    tiles = -(-npair // K2_TF32_PAIR_TILE) * -(-N // LANE_TILE)
    assert n_split >= 1 and steps % stage == 0
    bounds = [(s * steps, min(T, (s + 1) * steps)) for s in range(n_split)]
    assert all(b > a for a, b in bounds)                  # none empty
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(bounds[i][1] == bounds[i + 1][0]
               for i in range(n_split - 1))               # once, in order
    # The C launcher's rows per split, from n_split alone, is the same.
    rows = -(-T // n_split)
    assert -(-rows // stage) * stage == steps
    assert n_split * tiles <= max(n_sm, tiles)            # one wave
    if n_split > 1:
        assert steps >= 8 * stage
        assert 4 * n_split * npair * N <= T * N / 2       # the partials
    if (T, N, GB) == (100_000, 200, 32):                  # the flagship
        assert (n_split, steps) == (16, 6272)
        assert n_split * tiles == 128


@pytest.mark.parametrize("tile", [TF32_PAIR_TILE, K2_TF32_PAIR_TILE])
def test_tf32_shared_memory_fits_a_block(tile):
    for GB in range(1, 65):
        assert tf32_smem_bytes(GB, tile) <= 232448
    # 1024 bytes of alignment, 4 Z tiles of 128-byte rows, a ring of
    # stages of omega (32 x 136 floats) and the design rows (GB x 32).
    assert tf32_smem_bytes(64, tile) == (
        1024 + 4 * tile * 128
        + ss_cuda._RING_STAGES * (32 * 136 * 4 + 64 * 32 * 4))


def test_tf32_split():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(20000), rng.random(20000) * 1e-3,
        -rng.random(20000) * 1e4]).astype(np.float32))
    hi, lo = tf32_split(x)
    hb, lb = hi.view(torch.int32), lo.view(torch.int32)
    assert bool(((hb & 0x1FFF) == 0).all()) and bool(((lb & 0x1FFF) == 0)
                                                      .all())
    # hi within half a TF32 ulp (2^-11 relative), lo = x - hi cut toward
    # zero: |x - hi - lo| below 2^-11 |x - hi|, and of x - hi's sign.
    r = (x - hi).double()
    assert bool((r.abs() <= 2.0 ** -11 * x.double().abs()).all())
    cut = r - lo.double()
    assert bool((cut.abs() <= 2.0 ** -10 * r.abs()).all())
    assert bool((cut * r >= 0).all())
    # Ties go away from zero: 1 + 2^-11 lies halfway between two TF32s.
    t = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert torch.equal(tf32_split(t)[0], torch.tensor([1 + 2.0 ** -10,
                                                       -(1 + 2.0 ** -10)]))


def _tf32(x):
    return tuple(t.numpy() for t in tf32_split(torch.from_numpy(x)))


def _add_cut(acc, addend):
    """acc + addend (float64, exact) cut toward zero to 25 significant bits
    (one guard bit) and then rounded to float32: the tensor cores' add."""
    m, e = np.frexp(acc.astype(np.float64) + addend)
    return np.ldexp(np.trunc(m * 2.0 ** 25) / 2.0 ** 25, e).astype(np.float32)


def _emulate(Z, om, fold_steps):
    """C = Z om as the 3xTF32 body computes it, for one split of T."""
    zh, zl = _tf32(Z)
    oh, ol = _tf32(om)
    acc = np.zeros((Z.shape[0], om.shape[1]), np.float32)
    total = np.zeros_like(acc)
    for t0 in range(0, Z.shape[1], 8):
        k = slice(t0, t0 + 8)
        for a, b in ((zh, ol), (zl, oh), (zh, oh)):    # small terms first
            acc = _add_cut(acc, a[:, k].astype(np.float64)
                           @ b[k].astype(np.float64))
        if (t0 + 8) % fold_steps == 0:                  # Fast2Sum
            t = total + acc
            acc = acc - (t - total)
            total = t
    return total + acc


def test_tf32x3_emulation_against_float64():
    T, N, GB = 20_000, 16, 8
    gen = torch.Generator().manual_seed(11)
    Y = (torch.rand((T, 2), generator=gen) < 0.15).float()
    X = design_matrix(Y, cosine_basis(4, 10)).T.contiguous()[:GB]
    p, q = pair_index(GB)
    Z = (X[p] * X[q]).numpy()
    om = (0.05 + 0.2 * torch.rand((T, N), generator=gen)).numpy()
    ref = Z.astype(np.float64) @ om.astype(np.float64)

    def rel(c):
        return float(np.abs(c - ref).max() / np.abs(ref).max())
    plain = rel((torch.from_numpy(Z) @ torch.from_numpy(om)).numpy())
    folded = rel(_emulate(Z, om, TF32_FOLD_STEPS))
    unfolded = rel(_emulate(Z, om, 2 * T))
    assert folded <= 2 * plain, (folded, plain)
    # Without the folds the truncated adds drift, as on the card.
    assert unfolded > 20 * folded and 2e-5 < unfolded < 3e-4, unfolded
