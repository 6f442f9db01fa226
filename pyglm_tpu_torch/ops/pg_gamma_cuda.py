"""Wrapper of kernel K4 (``csrc/pg_gamma.cu``): PG(b, c) for real b by the
truncated gamma series on the card. The plain version is
``ops/polyagamma.py::pg_gamma_series_plain``."""
from __future__ import annotations

import math

import torch

from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.polyagamma import check_terms


def pg_gamma_series_cuda(b: torch.Tensor, c: torch.Tensor, seed: int,
                         offset: int, normal_cutoff: float = math.inf,
                         K: int = 4,
                         run_time_body: bool = False) -> torch.Tensor:
    """PG(b, c) for contiguous float32 CUDA tensors b and c of one shape:
    the normal approximation where b >= `normal_cutoff`, else 0 where
    b <= 0, else the gamma series of K exact terms. (seed, offset) select
    the Philox stream: element i draws from subsequence i at `offset`.

    K = 4 launches the body compiled for four terms; any other integer
    K >= 1 the body that reads K at run time (ValueError otherwise, as the
    plain version). `run_time_body` launches the latter at K = 4 too, to
    hold it against the four-term body on the same stream."""
    for name, x in (("b", b), ("c", c)):
        if not x.is_cuda:
            raise ValueError(f"pg_gamma_series_cuda needs CUDA tensors, "
                             f"{name} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"pg_gamma_series_cuda needs float32, {name} is "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pg_gamma_series_cuda needs contiguous "
                             f"tensors, {name} is not")
    if b.shape != c.shape or b.device != c.device:
        raise ValueError(f"b {tuple(b.shape)} on {b.device} and c "
                         f"{tuple(c.shape)} on {c.device} differ")
    if not (0 <= seed < 2 ** 64 and 0 <= offset < 2 ** 64):
        raise ValueError("seed and offset must fit in 64 unsigned bits")
    K = check_terms(K)
    out = torch.empty_like(c)
    lib = _build.library()
    with torch.cuda.device(c.device):
        err = lib.pg_gamma_series_launch(
            b.data_ptr(), c.data_ptr(), out.data_ptr(), c.numel(),
            normal_cutoff, seed, offset, K, int(run_time_body),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pg_gamma_series")
    _build.LAUNCHES["pg_gamma_series"] += 1
    return out
