"""The raised-cosine basis and the causal design matrix, in float64.

X[t, j, k] = sum_{d=1..L} Y[t-d, j] basis[d-1, k]: the design row at time
t sees only spikes strictly before t. Xf = (T, N*B + 1), presyn-major and
basis-minor, its last column all ones (the bias).
"""
from __future__ import annotations

import numpy as np
import torch


def cosine_basis(B: int, L: int) -> np.ndarray:
    """(L, B): B half-cosine bumps over L bins, peaks spaced evenly in
    log(t + 1), each bump as wide as twice the spacing, each column
    summing to one (Pillow et al. 2008's log-time raised cosines)."""
    w = np.log(np.arange(L, dtype=np.float64) + 1.0)
    if B == 1:
        peaks = np.array([(w[0] + w[-1]) / 2.0])
        dw = max(w[-1] - w[0], 1.0) / 2.0
    else:
        peaks = np.linspace(w[0], w[-1], B)
        dw = peaks[1] - peaks[0]
    arg = np.clip((w[:, None] - peaks[None, :]) * np.pi / (2.0 * dw),
                  -np.pi, np.pi)
    basis = 0.5 * (1.0 + np.cos(arg))
    return basis / np.maximum(basis.sum(axis=0, keepdims=True), 1e-12)


def design(Y: torch.Tensor, B: int, L: int) -> torch.Tensor:
    """Xf (T, N*B + 1) in float64 on Y's device, by L shifted adds."""
    T, N = Y.shape
    basis = torch.as_tensor(cosine_basis(B, L), device=Y.device)
    Yd = Y.to(torch.float64)
    X = torch.zeros((T, N, B), dtype=torch.float64, device=Y.device)
    for d in range(1, L + 1):
        X[d:] += Yd[:T - d, :, None] * basis[d - 1]
    return torch.cat([X.reshape(T, N * B),
                      torch.ones((T, 1), dtype=torch.float64,
                                 device=Y.device)], dim=1)
