"""Kernel K6 (``csrc/group_gram.cu``): the omega-weighted within-group Gram
blocks of every presyn group in one launch, with its plain PyTorch version.

It replaces ``pyglm_tpu/ops/gram_pallas.py::group_gram_blocks_pallas_t``
(f32 body ``_gram_kernel_f32``, bf16x3 on the TPU), which the JAX
package's staged spike-and-slab path runs once per sweep before its group
loop at precision "high". At "high" the kernel runs 3xTF32 on the tensor
cores; at "highest" (where the JAX package takes its f32 XLA Gram) an fp32
FMA body.

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
from pyglm_tpu_torch.ops.ss_cuda import _MAX_GB, _check_cuda_f32, pair_index


def _n_groups(Xt, B: int, G: int) -> int:
    """Ng of a (P, T) design with its bias row last (P = N_pre B + 1)."""
    n_pre = (Xt.shape[0] - 1) // B
    if n_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={n_pre}")
    return n_pre // G


def group_gram_blocks_plain(Xt, omega, B: int, G: int) -> torch.Tensor:
    """Plain version of K6: per group, (xg[p] * xg[q]) @ omega over the
    pairs p <= q. Returns the packed (Ng, GB(GB+1)/2, N)."""
    Ng, GB = _n_groups(Xt, B, G), G * B
    p, q = pair_index(GB, Xt.device)
    out = omega.new_empty((Ng, p.numel(), omega.shape[1]))
    for g in range(Ng):
        xg = Xt[g * GB:(g + 1) * GB]
        out[g] = (xg[p] * xg[q]) @ omega
    return out


def group_gram_blocks_cuda(Xt, omega, B: int, G: int,
                           precision: str = "highest") -> torch.Tensor:
    """K6 on the card; same contract as :func:`group_gram_blocks_plain`.
    ``precision="high"`` runs the 3xTF32 tensor-core body, "highest" the
    fp32 FMA body."""
    if precision not in ("high", "highest"):
        raise ValueError(f"group_gram: precision={precision!r}, need 'high' "
                         f"or 'highest'")
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
        err = lib.group_gram_launch(
            Xt.data_ptr(), omega.data_ptr(), out.data_ptr(), T, N, GB, Ng,
            int(precision == "high"), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_gram")
    _build.LAUNCHES["group_gram"] += 1
    return out
