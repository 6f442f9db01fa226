"""Kernel K6 (``csrc/group_gram.cu``): the omega-weighted within-group Gram
blocks of every presyn group in one launch, with its plain PyTorch version.

It replaces ``pyglm_tpu/ops/gram_pallas.py::group_gram_blocks_pallas_t``
with both its bodies, which the JAX package's staged spike-and-slab path
runs once per sweep before its group loop: ``_gram_kernel_f32`` (bf16x3 on
the TPU) at precision "high" and "sr", ``_gram_kernel_fast`` (one bf16
pass) at "default". The kernel's bodies: "high" 3xTF32 on the tensor cores,
"default" one bf16 pass on the tensor cores (Z and omega rounded to nearest
even), "highest" (where the JAX package takes its f32 XLA Gram) fp32 FMA.

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
    _MAX_GB, _check_cuda_f32, pair_index, to_bf16,
)

# K6's bodies (csrc/group_gram.cu::group_gram_launch) and their counters.
_BODIES = {"highest": 0, "high": 1, "default": 2}
_K6_KEYS = {"highest": "group_gram", "high": "group_gram",
            "default": "group_gram_bf16"}


def _n_groups(Xt, B: int, G: int) -> int:
    """Ng of a (P, T) design with its bias row last (P = N_pre B + 1)."""
    n_pre = (Xt.shape[0] - 1) // B
    if n_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={n_pre}")
    return n_pre // G


def _check_body(precision: str) -> None:
    if precision not in _BODIES:
        raise ValueError(f"group_gram: precision={precision!r}, one of "
                         f"{tuple(_BODIES)}")


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
    bf16 tensor-core body, "highest" the fp32 FMA body."""
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
        err = lib.group_gram_launch(
            Xt.data_ptr(), omega.data_ptr(), out.data_ptr(), T, N, GB, Ng,
            _BODIES[precision], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_gram")
    _build.LAUNCHES[_K6_KEYS[precision]] += 1
    return out
