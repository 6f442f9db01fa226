"""The host-side pieces of K2's bf16 and SR Gram body (the wgmma body of
``csrc/gram_wgmma.cuh``, launched by ``ops/ss_cuda.py``), on the CPU. The
kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py).

- pair_tile_plan at K2's tile width covers each packed pair once, for GB
  1..64.
- gram_split_plan: the splits of T start on multiples of the 64-step stage,
  cover [0, T) once with none empty, keep the grid within one wave of the
  card's SMs (or one split where the tiles alone exceed it), give each
  split at least 8 stages where T allows more than one split, and keep the
  partials at most a quarter of the bf16 omega stream's bytes.
- ss_group_pass checks the bf16 omega operand it is given (dtype, shape,
  layout, device) on either device.
- The fused loop at "default" and "sr" makes one bf16 omega stream per
  update, ``omega_bf16_stream(omega)``, and hands that one tensor, and no
  float32 omega, to every K2 call: the scatter, sum_t omega and the Gram
  all read it. At "high" K2 gets the float32 omega and no stream.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops import ss_cuda
from pyglm_tpu_torch.ops.ss_cuda import (
    K2_PAIR_TILE, LANE_TILE, STAGE_STEPS, gram_split_plan, omega_bf16_stream,
    pair_index, pair_tile_plan, ss_group_pass)

torch.set_num_threads(1)


@pytest.mark.parametrize("GB", [1, 4, 32, 64])
@pytest.mark.parametrize("N", [7, 200, 4001])
@pytest.mark.parametrize("T", [1, 63, 64, 4099, 100_000])
def test_gram_split_plan(T, N, GB):
    n_sm = 132
    n_split, steps = gram_split_plan(T, N, GB, n_sm)
    npair = GB * (GB + 1) // 2
    tiles = -(-npair // K2_PAIR_TILE) * -(-N // LANE_TILE)
    assert n_split >= 1 and steps % STAGE_STEPS == 0
    bounds = [(s * steps, min(T, (s + 1) * steps)) for s in range(n_split)]
    assert all(b > a for a, b in bounds)                  # none empty
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(bounds[i][1] == bounds[i + 1][0]
               for i in range(n_split - 1))               # once, in order
    # The C launcher's rows per split, from n_split alone, is the same.
    rows = -(-T // n_split)
    assert -(-rows // STAGE_STEPS) * STAGE_STEPS == steps
    assert n_split * tiles <= max(n_sm, tiles)            # one wave
    if n_split > 1:
        assert steps >= 8 * STAGE_STEPS
        assert 4 * n_split * npair * N <= T * (-(-N // 8) * 8) * 2 / 4
    if (T, N, GB) == (100_000, 200, 32):                  # the flagship
        assert n_split * tiles <= n_sm < (n_split + 1) * tiles


@pytest.mark.parametrize("GB", range(1, 65))
def test_k2_pair_tile_plan_covers_each_pair_once(GB):
    """K2's pair table (tiles of K2_PAIR_TILE rows): every packed pair row
    once, in order, the padding only past the last pair."""
    table = pair_tile_plan(GB, tile=K2_PAIR_TILE)
    p, q = pair_index(GB)
    npair = p.numel()
    assert table.dtype == torch.int16
    assert table.numel() == -(-npair // K2_PAIR_TILE) * K2_PAIR_TILE
    e = table.to(torch.int32) & 0xFFFF
    assert bool((e[npair:] == 0xFFFF).all())
    assert torch.equal(e[:npair] & 0xFF, p.to(torch.int32))
    assert torch.equal(e[:npair] >> 8, q.to(torch.int32))


def _k2_inputs(T=130, N=12, GB=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))
    return f(GB, T), f(GB, T), 0.05 + 0.2 * f(T, N), f(T, N), f(GB, N)


@pytest.mark.parametrize("bad", ["float32", "no_pad", "rows", "strided",
                                 "float16"])
def test_group_pass_rejects_a_wrong_bf16_operand(bad):
    xp, xg, om, u, dw = _k2_inputs()
    T, N = om.shape
    good = omega_bf16_stream(om)
    wrong = {"float32": good.float(),
             "no_pad": om.to(torch.bfloat16),
             "rows": good[:-1],
             "strided": torch.zeros((T, 32), dtype=torch.bfloat16)[:, :16],
             "float16": good.to(torch.float16)}[bad]
    with pytest.raises(ValueError, match="om16"):
        ss_group_pass(xp, xg, om, u, dw, precision="default", om16=wrong)
    # The right operand passes, and the plain version does not read it.
    out = ss_group_pass(xp, xg, om, u.clone(), dw, precision="default",
                        om16=good)
    ref = ss_group_pass(xp, xg, om, u.clone(), dw, precision="default")
    assert all(torch.equal(a, b) for a, b in zip(out[:2], ref[:2]))


@pytest.mark.parametrize("precision", ["default", "sr", "high"])
def test_fused_loop_makes_one_bf16_stream_per_update(monkeypatch,
                                                     precision):
    T, N, B, G = 500, 8, 2, 2
    rng = np.random.default_rng(3)
    P = N * B + 1
    Xt = torch.from_numpy(rng.random((P, T)).astype(np.float32))
    omega = torch.from_numpy((0.05 + 0.2 * rng.random((T, N))).astype(
        np.float32))
    kappa = torch.from_numpy((rng.random((T, N)) < 0.2).astype(np.float32)
                             - 0.5)
    w_full = torch.zeros((P, N))
    hyp = tw.EdgeHypers(mu=torch.zeros((N, N, B)),
                        Lam=torch.eye(B).expand(N, N, B, B).contiguous(),
                        logit_rho=torch.full((N, N), -1.0),
                        mu_b=torch.zeros(N), lam_b=torch.ones(N))
    seen = []

    def spy(xp, xg, om, u, dw, want_sum_omega=False, precision="high",
            sr_seed=(0, 0), om16=None):
        seen.append((xg is not None, om16, om))
        return ss_cuda.ss_group_pass(xp, xg, om, u, dw, want_sum_omega,
                                     precision, sr_seed, om16)
    monkeypatch.setattr(tw, "ss_group_pass", spy)
    gen = torch.Generator().manual_seed(0)
    tw.resample_spike_slab_tspace(
        gen, Xt, omega, kappa, torch.zeros((T, N)), w_full, hyp, B,
        group=G, path="fused", precision=precision,
        host_generator=torch.Generator().manual_seed(1))
    assert len(seen) == N // G + 1
    if precision == "high":
        assert all(s[1] is None and s[2] is omega for s in seen)
        return
    om16 = seen[0][1]
    assert all(s[1] is om16 for s in seen)                # one per update
    assert om16.dtype == torch.bfloat16 and om16.shape == (T, 8)
    assert torch.equal(om16, omega_bf16_stream(omega))
    assert all(s[2] is None for s in seen)        # the stream is K2's omega
