"""Wrapper of kernel K1 (``csrc/pg_devroye.cu``): exact PG(1, c) draws on
the card. The plain version is ``ops/polyagamma.py::pg_devroye_plain``."""
from __future__ import annotations

import torch

from pyglm_tpu_torch.ops import _build


def pg_devroye_cuda(c: torch.Tensor, seed: int, offset: int) -> torch.Tensor:
    """PG(1, c) for a contiguous float32 CUDA tensor of any shape.

    (seed, offset) select the Philox stream: element i draws from
    subsequence i at `offset`, so a new (seed, offset) pair gives
    independent draws.
    """
    if not c.is_cuda:
        raise ValueError(f"pg_devroye_cuda needs a CUDA tensor, got {c.device}")
    if c.dtype != torch.float32:
        raise TypeError(f"pg_devroye_cuda needs float32, got {c.dtype}")
    if not c.is_contiguous():
        raise ValueError("pg_devroye_cuda needs a contiguous tensor")
    if not (0 <= seed < 2 ** 64 and 0 <= offset < 2 ** 64):
        raise ValueError("seed and offset must fit in 64 unsigned bits")
    out = torch.empty_like(c)
    lib = _build.library()
    with torch.cuda.device(c.device):
        err = lib.pg_devroye_launch(
            c.data_ptr(), out.data_ptr(), c.numel(), seed, offset,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pg_devroye")
    _build.LAUNCHES["pg_devroye"] += 1
    return out
