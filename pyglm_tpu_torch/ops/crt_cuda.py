"""Wrapper of kernel K5 (``csrc/crt.cu``): Chinese-restaurant-table counts
on the card. The plain version is ``ops/linalg.py::crt_sample_plain``."""
from __future__ import annotations

import torch

from pyglm_tpu_torch.ops import _build


def crt_sample_cuda(y: torch.Tensor, r: torch.Tensor, max_y: int, seed: int,
                    offset: int) -> torch.Tensor:
    """l = sum_{i < min(y, max_y)} Bern(r / (r + i)) as int32, for a
    contiguous CUDA `y` (int32 or float32, last dimension N) and a
    contiguous float32 `r` of shape (N,), read by column. (seed, offset)
    select the Philox stream: element i draws from subsequence i."""
    if not (y.is_cuda and r.is_cuda):
        raise ValueError(f"crt_sample_cuda needs CUDA tensors, got y on "
                         f"{y.device} and r on {r.device}")
    if y.dtype not in (torch.int32, torch.float32) or r.dtype != torch.float32:
        raise TypeError(f"crt_sample_cuda needs int32 or float32 y and "
                        f"float32 r, got {y.dtype} and {r.dtype}")
    if not (y.is_contiguous() and r.is_contiguous()):
        raise ValueError("crt_sample_cuda needs contiguous tensors")
    if y.ndim == 0 or r.shape != y.shape[-1:] or r.device != y.device:
        raise ValueError(f"r must have shape (N,) = {tuple(y.shape[-1:])} "
                         f"on {y.device}, got {tuple(r.shape)} on {r.device}")
    if not (0 <= seed < 2 ** 64 and 0 <= offset < 2 ** 64):
        raise ValueError("seed and offset must fit in 64 unsigned bits")
    out = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.crt_sample_launch(
            y.data_ptr(), int(y.dtype == torch.float32), r.data_ptr(),
            out.data_ptr(), y.numel(), r.numel(), max_y, seed, offset,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "crt_sample")
    _build.LAUNCHES["crt_sample"] += 1
    return out
