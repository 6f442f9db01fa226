"""Kernel K6 (``csrc/group_gram.cu``): the omega-weighted within-group Gram
blocks of every presyn group in one launch, with its plain PyTorch version.

It replaces ``pyglm_tpu/ops/gram_pallas.py::group_gram_blocks_pallas_t``
with both its bodies, which the JAX package's staged spike-and-slab path
runs once per sweep before its group loop: ``_gram_kernel_f32`` (bf16x3 on
the TPU) at precision "high" and "sr", ``_gram_kernel_fast`` (one bf16
pass) at "default". The kernel's bodies: "high" 3xTF32 on the tensor cores,
"default" one bf16 pass on wgmma (omega rounded once to a bf16 stream, Z
rounded to nearest even as it is formed, tiles of 168 pair rows), "highest"
(where the JAX package takes its f32 XLA Gram) fp32 FMA on 80 x 200
tiles, T split where the grid is small (:func:`fp32_split_plan`).

Layouts (float32, contiguous):
  Xt    (P, T)    transposed design; group g is rows [g GB, (g + 1) GB)
  omega (T, N)    N postsyn lanes
  Jg    (Ng, GB(GB+1)/2, N)  packed upper triangle per group, row-major over
                             p <= q (``torch.triu_indices``, as K2's Gram)

Dispatch (:func:`models.weights.group_gram_blocks`): CUDA tensors launch
the kernel, CPU tensors take :func:`group_gram_blocks_plain`.
"""
from __future__ import annotations

import torch

from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.ss_cuda import (
    _H100_SMS, _MAX_GB, PAIR_TILE, _check_cuda_f32, _pair_table,
    omega_bf16_stream, pair_index, to_bf16,
)

# K6's bodies (csrc/group_gram.cu: group_gram_fp32_launch,
# group_gram_launch, group_gram_bf16_launch) and their counters.
_K6_KEYS = {"highest": "group_gram", "high": "group_gram",
            "default": "group_gram_bf16"}


# The fp32 body's stage and fold (steps) and its tile: 8 FP32_RY pair rows
# x 8 FP32_NX lanes on FP32_RY FP32_NX threads (csrc/group_gram.cu: kFS,
# kFoldStages, kRY, kNX).
FP32_STAGE, FP32_FOLD = 16, 512
FP32_RY, FP32_NX = 10, 25


def fp32_smem_bytes(GB: int) -> int:
    """Shared memory of one block of the fp32 body (``fp32_smem_floats``):
    2 omega and 2 Z stages, 3 design stages and 64 second sums a thread."""
    return 4 * (2 * FP32_STAGE * 8 * (FP32_NX + FP32_RY)
                + 3 * FP32_STAGE * (GB | 1) + 64 * FP32_RY * FP32_NX)


def fp32_split_plan(GB: int, N: int, T: int, Ng: int,
                    n_sm: int = _H100_SMS) -> tuple[int, int]:
    """(n_split, steps) of K6's fp32 body for Ng groups of GB rows: T split
    into n_split ranges of `steps` steps, a multiple of the 512-step fold
    (so every fold falls where it falls unsplit), no range empty. A grid
    of tiles that fills one wave of 2 `n_sm` blocks (two share an SM) runs
    unsplit; a smaller one takes the split, of at most 64, with the
    fewest waves x steps a block walks, ties going to fewer splits. At the
    flagship (GB = 32, 200 lanes, T = 1e5, 25 groups: 175 tiles) that is 3
    splits of 33792 steps, 525 blocks in 2 waves; the splits measured on
    the card are in PERF.md (``time_group_gram.py --splits``)."""
    npair = GB * (GB + 1) // 2
    tiles = Ng * -(-npair // (8 * FP32_RY)) * -(-N // (8 * FP32_NX))
    chunks = -(-T // FP32_FOLD)
    if tiles >= 2 * n_sm:
        return 1, chunks * FP32_FOLD
    best = None
    for split in range(1, min(chunks, 64) + 1):
        per = -(-chunks // split)
        if -(-chunks // per) != split:
            continue
        cost = -(-tiles * split // (2 * n_sm)) * per
        if best is None or cost < best[0]:
            best = (cost, split, per * FP32_FOLD)
    return best[1], best[2]


def _n_groups(Xt, B: int, G: int) -> int:
    """Ng of a (P, T) design with its bias row last (P = N_pre B + 1)."""
    n_pre = (Xt.shape[0] - 1) // B
    if n_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={n_pre}")
    return n_pre // G


def _check_body(precision: str) -> None:
    if precision not in _K6_KEYS:
        raise ValueError(f"group_gram: precision={precision!r}, one of "
                         f"{tuple(_K6_KEYS)}")


def group_gram_blocks_plain(Xt, omega, B: int, G: int,
                            precision: str = "highest") -> torch.Tensor:
    """Plain version of K6: per group, (xg[p] * xg[q]) @ omega over the
    pairs p <= q, in fp32 at "high" and "highest" and on Z and omega
    rounded to bf16 at "default" (exact products, fp32 sums). Returns the
    packed (Ng, GB(GB+1)/2, N)."""
    _check_body(precision)
    Ng, GB = _n_groups(Xt, B, G), G * B
    p, q = pair_index(GB, Xt.device)
    out = omega.new_empty((Ng, p.numel(), omega.shape[1]))
    om = to_bf16(omega) if precision == "default" else omega
    for g in range(Ng):
        xg = Xt[g * GB:(g + 1) * GB]
        Z = xg[p] * xg[q]
        out[g] = (to_bf16(Z) if precision == "default" else Z) @ om
    return out


def group_gram_blocks_cuda(Xt, omega, B: int, G: int,
                           precision: str = "highest") -> torch.Tensor:
    """K6 on the card; same contract as :func:`group_gram_blocks_plain`.
    ``precision="high"`` runs the 3xTF32 tensor-core body, "default" the
    bf16 wgmma body (on :func:`omega_bf16_stream`, made here), "highest"
    the fp32 FMA body on the split of T of :func:`fp32_split_plan` (with
    a (n_split, Ng, GB(GB+1)/2, N) scratch for the partials when it splits
    T)."""
    _check_body(precision)
    T, N = omega.shape
    Ng, GB = _n_groups(Xt, B, G), G * B
    if not 1 <= GB <= _MAX_GB:
        raise ValueError(f"group_gram: GB={GB} outside 1..{_MAX_GB}")
    _check_cuda_f32("Xt", Xt, (Xt.shape[0], T))
    _check_cuda_f32("omega", omega, (T, N))
    out = torch.empty((Ng, GB * (GB + 1) // 2, N), dtype=torch.float32,
                      device=omega.device)
    lib = _build.library()
    with torch.cuda.device(omega.device):
        stream = torch.cuda.current_stream().cuda_stream
        if precision == "default":
            om16 = omega_bf16_stream(omega)
            pq = _pair_table(GB, omega.device)
            err = lib.group_gram_bf16_launch(
                Xt.data_ptr(), om16.data_ptr(), pq.data_ptr(),
                out.data_ptr(), T, N, om16.shape[1], GB, Ng,
                pq.numel() // PAIR_TILE, stream)
        elif precision == "highest":
            n_split, steps = fp32_split_plan(GB, N, T, Ng)
            part = (out.new_empty((n_split,) + out.shape) if n_split > 1
                    else None)
            err = lib.group_gram_fp32_launch(
                Xt.data_ptr(), omega.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), T, N, GB, Ng,
                n_split, steps, stream)
        else:
            err = lib.group_gram_launch(
                Xt.data_ptr(), omega.data_ptr(), out.data_ptr(), T, N, GB,
                Ng, stream)
    _build.check(err, "group_gram")
    _build.LAUNCHES[_K6_KEYS[precision]] += 1
    return out


def wgmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One warpgroup's k-loop (4 wgmma k-steps) through the "default"
    body's shared-memory layouts, descriptors and accumulator map: a (64
    steps, 64 lanes) and b (PAIR_TILE rows, 64 steps), contiguous bf16 on
    the card; returns a^T b^T, (64, PAIR_TILE) float32. A check of the
    tile machinery on known tiles, not a kernel of any path."""
    if (a.shape != (64, 64) or b.shape != (PAIR_TILE, 64)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or not (a.is_cuda and b.is_cuda and a.is_contiguous()
                    and b.is_contiguous())):
        raise ValueError("wgmma_probe: need contiguous bf16 CUDA tensors "
                         f"(64, 64) and ({PAIR_TILE}, 64)")
    d = torch.empty((64, PAIR_TILE), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().wgmma_probe_launch(
            a.data_ptr(), b.data_ptr(), d.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "wgmma_probe")
    return d
