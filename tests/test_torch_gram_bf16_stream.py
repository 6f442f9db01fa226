"""The host-side pieces of K6's "default" body (ops/gram_cuda.py, with the
helpers it shares with K2 in ops/ss_cuda.py), on the CPU: the bf16 omega
stream the kernel reads and the pair-tile plan its blocks take. The kernel
itself is held against its plain version on the card
(tests/test_torch_cuda.py).

- omega_bf16_stream: (T, N8) torch.bfloat16, N8 = N rounded up to a
  multiple of 8 (16-byte rows), the pad lanes zero, the first N lanes equal
  to ``to_bf16(omega)`` (round to nearest even) bit for bit.
- pair_tile_plan: for every GB in 1..64, the tiles of PAIR_TILE rows cover
  every packed pair row (``pair_index``, row-major over p <= q) exactly
  once, in order, with the padding only past the last pair.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.ops import gram_cuda
from pyglm_tpu_torch.ops.ss_cuda import (
    PAIR_TILE, omega_bf16_stream, pair_index, pair_tile_plan, to_bf16)

torch.set_num_threads(1)


@pytest.mark.parametrize("T,N", [(5, 1), (40, 7), (64, 8), (300, 70),
                                 (97, 130), (33, 4001)])
def test_omega_bf16_stream(T, N):
    rng = np.random.default_rng(N)
    om = torch.from_numpy((0.05 + 0.3 * rng.random((T, N))).astype(np.float32))
    # Ties and near-ties of the bf16 rounding: 1 + 2^-8 rounds to 1 (even),
    # 1 + 3 * 2^-8 up to 1 + 2^-6.
    om[0, 0] = 1.0 + 2.0 ** -8
    om[-1, -1] = 1.0 + 3 * 2.0 ** -8
    s = omega_bf16_stream(om)
    N8 = -(-N // 8) * 8
    assert s.shape == (T, N8) and s.dtype == torch.bfloat16
    assert s.is_contiguous() and (s.shape[1] * 2) % 16 == 0
    assert torch.equal(s[:, :N].float(), to_bf16(om))
    assert float(s[0, 0]) == 1.0 and float(s[-1, N - 1]) == 1.0 + 2.0 ** -6
    assert not s[:, N:].float().any()


@pytest.mark.parametrize("GB", range(1, 65))
def test_pair_tile_plan_covers_each_pair_once(GB):
    table = pair_tile_plan(GB)
    p, q = pair_index(GB)
    npair = GB * (GB + 1) // 2
    n_tiles = table.numel() // PAIR_TILE
    assert table.dtype == torch.int16 and table.numel() % PAIR_TILE == 0
    assert n_tiles == -(-npair // PAIR_TILE)
    e = table.to(torch.int32) & 0xFFFF
    valid = e != 0xFFFF
    # The valid entries are the first npair: the padding lies in the last
    # tile only, after the last pair.
    assert int(valid.sum()) == npair and bool(valid[:npair].all())
    assert (n_tiles - 1) * PAIR_TILE < npair
    tp, tq = e[:npair] & 0xFF, e[:npair] >> 8
    assert torch.equal(tp, p.to(torch.int32)) and torch.equal(tq, q.to(
        torch.int32))
    assert bool((tp <= tq).all()) and int(tq.max()) < GB
    # Each (p, q) once: pairs decode to distinct packed rows.
    assert len(set(zip(tp.tolist(), tq.tolist()))) == npair


def test_default_body_rejects_cpu_tensors():
    Xt = torch.zeros((4 * 4 + 1, 100))
    om = torch.zeros((100, 6))
    with pytest.raises(ValueError):
        gram_cuda.group_gram_blocks_cuda(Xt, om, 4, 2, precision="default")
    with pytest.raises(ValueError):
        gram_cuda.wgmma_probe(torch.zeros((64, 64), dtype=torch.bfloat16),
                              torch.zeros((PAIR_TILE, 64),
                                          dtype=torch.bfloat16))
