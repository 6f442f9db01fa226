"""Raised-cosine temporal basis and causal spike-history convolution
(PyTorch counterpart of ``pyglm_tpu/ops/basis.py``).

Conventions (the reference's causal one-bin shift):
    X[t, n, b] = sum_{d=1..L} Y[t-d, n] * basis[d-1, b]
so the design row at time t only sees spikes strictly before t.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def cosine_basis(B: int, L: int, orth: bool = False, norm: bool = True,
                 offset: float = 1.0) -> np.ndarray:
    """Raised-cosine basis (Pillow-style log-time warping), (L, B) float32.

    A numpy copy of ``pyglm_tpu.ops.basis.cosine_basis``: B filters over L
    bins, peaks spaced linearly in w(t) = log(t + offset), each filter half
    a cosine bump of width twice the peak spacing. ``norm`` L1-normalizes
    each column; ``orth`` orthonormalizes the columns (QR).
    """
    if B < 1 or L < 1:
        raise ValueError(f"need B >= 1 and L >= 1, got B={B}, L={L}")
    t = np.arange(L, dtype=np.float64)
    w = np.log(t + offset)
    lo, hi = w[0], w[-1]
    if B == 1:
        peaks = np.array([(lo + hi) / 2.0])
        dw = max(hi - lo, 1.0) / 2.0
    else:
        peaks = np.linspace(lo, hi, B)
        dw = peaks[1] - peaks[0]
    arg = np.clip((w[:, None] - peaks[None, :]) * np.pi / (2.0 * dw),
                  -np.pi, np.pi)
    basis = 0.5 * (1.0 + np.cos(arg))
    if norm:
        basis = basis / np.maximum(basis.sum(axis=0, keepdims=True), 1e-12)
    if orth:
        q, _ = np.linalg.qr(basis)
        signs = np.sign(q[np.argmax(np.abs(q), axis=0), np.arange(B)])
        basis = q * signs[None, :]
    return basis.astype(np.float32)


def convolve_with_basis(Y: torch.Tensor, basis) -> torch.Tensor:
    """Causal convolution of a (T, N) spike matrix with an (L, B) basis.

    Returns the (T, N, B) float32 design tensor
    X[t, n, b] = sum_{d=1..L} Y[t-d, n] * basis[d-1, b] (zero before t=0),
    on Y's device.
    """
    basis = torch.as_tensor(np.asarray(basis, np.float32), device=Y.device)
    L, B = basis.shape
    T, N = Y.shape
    x = Y.T.to(torch.float32)[:, None, :]                  # (N, 1, T)
    # conv1d is a cross-correlation: the reversed filter over an input
    # left-padded by L gives the causal sum; output row t = T is dropped.
    weight = basis.flip(0).T[:, None, :].contiguous()      # (B, 1, L)
    cudnn = torch.backends.cudnn
    # cuDNN runs float32 convolutions in TF32 by default (~3 decimal
    # digits). The design is the data and must match the JAX package's
    # full-f32 conv, so TF32 is switched off here; the CPU ignores it.
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv1d(F.pad(x, (L, 0)), weight)           # (N, B, T+1)
    return out[:, :, :T].permute(2, 0, 1)


def design_matrix(Y: torch.Tensor, basis,
                  with_bias: bool = True) -> torch.Tensor:
    """Flattened design Xf = (T, N*B [+1]), presyn-major, basis-minor:
    Xf[:, j*B + b] = X[:, j, b]; the last column (with_bias) is all ones."""
    X = convolve_with_basis(Y, basis)
    T, N, B = X.shape
    Xf = X.reshape(T, N * B)
    if with_bias:
        Xf = torch.cat([Xf, torch.ones((T, 1), dtype=Xf.dtype,
                                       device=Xf.device)], dim=1)
    return Xf
