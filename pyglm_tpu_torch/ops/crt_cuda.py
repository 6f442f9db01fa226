"""Wrappers of kernel K5 (``csrc/crt.cu``): Chinese-restaurant-table counts
on the card, per element (:func:`crt_sample_cuda`) and summed per column
(:func:`crt_sample_sums_cuda`), and :func:`crt_sample_twin`, which repeats
the kernel's draws in numpy. The plain version is
``ops/linalg.py::crt_sample_plain``."""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.ss_cuda import philox4x32

_MAX_NUMEL = 2 ** 31 - 1    # K5 indexes elements in 32 bits
_MAX_Y = 2 ** 20


def _check(name, y, r, max_y, seed, offset):
    if not (y.is_cuda and r.is_cuda):
        raise ValueError(f"{name} needs CUDA tensors, got y on {y.device} "
                         f"and r on {r.device}")
    if y.dtype not in (torch.int32, torch.float32) or r.dtype != torch.float32:
        raise TypeError(f"{name} needs int32 or float32 y and float32 r, got "
                        f"{y.dtype} and {r.dtype}")
    if not (y.is_contiguous() and r.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
    if y.ndim == 0 or r.shape != y.shape[-1:] or r.device != y.device:
        raise ValueError(f"r must have shape (N,) = {tuple(y.shape[-1:])} "
                         f"on {y.device}, got {tuple(r.shape)} on {r.device}")
    if r.numel() == 0 or y.numel() > _MAX_NUMEL:
        raise ValueError(f"{name} takes 1 <= N and numel < 2^31, got shape "
                         f"{tuple(y.shape)}")
    if not 0 <= max_y <= _MAX_Y:
        raise ValueError(f"{name} takes 0 <= max_y <= {_MAX_Y}, got {max_y}")
    if not (0 <= seed < 2 ** 64 and 0 <= offset < 2 ** 64):
        raise ValueError("seed and offset must fit in 64 unsigned bits")


def _launch(name, y, r, out, sums, max_y, seed, offset):
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.crt_sample_launch(
            y.data_ptr(), int(y.dtype == torch.float32), r.data_ptr(),
            out.data_ptr(), int(sums), y.numel(), r.numel(), max_y, seed,
            offset, torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def crt_sample_cuda(y: torch.Tensor, r: torch.Tensor, max_y: int, seed: int,
                    offset: int) -> torch.Tensor:
    """l = sum_{k < min(y, max_y)} Bern(r / (r + k)) as int32, for a
    contiguous CUDA `y` (int32 or float32 whole counts, last dimension N)
    and a contiguous float32 `r` of shape (N,), read by column. (seed,
    offset) key the Philox draws (:func:`crt_sample_twin`)."""
    _check("crt_sample_cuda", y, r, max_y, seed, offset)
    out = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    return _launch("crt_sample", y, r, out, False, max_y, seed, offset)


def crt_sample_sums_cuda(y: torch.Tensor, r: torch.Tensor, max_y: int,
                         seed: int, offset: int) -> torch.Tensor:
    """The counts of :func:`crt_sample_cuda` with the same (seed, offset),
    summed per column: int64 (N,). No (T, N) array is written."""
    _check("crt_sample_sums_cuda", y, r, max_y, seed, offset)
    out = torch.zeros(r.shape, dtype=torch.int64, device=y.device)
    return _launch("crt_sample_sums", y, r, out, True, max_y, seed, offset)


def crt_sample_twin(y, r, max_y: int, seed: int, offset: int,
                    chunk: int = 1 << 20) -> np.ndarray:
    """K5's counts in numpy, draw for draw: int32 of y's shape. Trial 0
    seats a table iff m = min(y, max_y) > 0 and r > 0; trial k >= 1 iff
    u (r + k) < r in float32, u = (w >> 8) 2^-24, w word (k - 1) % 4 of
    the Philox4x32-10 draw with counter ((k - 1) // 4, element, offset lo,
    offset hi) and key (seed lo, seed hi). Elements are taken `chunk` at a
    time, the chunks on a thread pool."""
    y = np.asarray(y)
    N = y.shape[-1]
    yf = y.reshape(-1)
    if np.issubdtype(yf.dtype, np.floating):      # NaN and y < 1: no trial
        yf = np.where(yf >= 1, np.minimum(yf, max_y), 0)
    m_all = np.clip(yf, 0, max_y).astype(np.int32)
    rr = np.broadcast_to(np.asarray(r, np.float32).reshape(-1), (N,))
    out = np.empty(m_all.size, np.int32)
    M32 = np.uint64(0xFFFFFFFF)
    off, sd = np.uint64(offset), np.uint64(seed)

    def counts(e0):
        m = m_all[e0:e0 + chunk].astype(np.int64)
        re = rr[np.arange(e0, e0 + m.size) % N]
        cnt = ((m > 0) & (re > 0)).astype(np.int64)
        units = (m + 2) >> 2
        loc = np.repeat(np.arange(m.size), units)
        q = np.arange(loc.size) - np.repeat(np.cumsum(units) - units, units)
        words = philox4x32((q.astype(np.uint64),
                            (loc + e0).astype(np.uint64), off & M32,
                            off >> np.uint64(32)),
                           (sd & M32, sd >> np.uint64(32)))
        ru, mu = re[loc], m[loc]
        for j, w in enumerate(words):
            k = 1 + 4 * q + j
            u = (w >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
            ok = (k < mu) & (u * (ru + k.astype(np.float32)) < ru)
            cnt += np.bincount(loc, weights=ok,
                               minlength=m.size).astype(np.int64)
        out[e0:e0 + m.size] = cnt

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(counts, range(0, m_all.size, chunk)))
    return out.reshape(y.shape)
