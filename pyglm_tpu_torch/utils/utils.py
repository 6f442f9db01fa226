"""Small numeric helpers (PyTorch counterpart of ``pyglm_tpu/utils/utils.py``).

``logistic``/``logit``/``softplus`` act on tensors; ``expand_scalar`` and
``expand_cov`` broadcast static hyperparameters on the host and return numpy
arrays, exactly as the JAX package does.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def logistic(x):
    """Logistic sigmoid, written as the JAX package writes it."""
    return 1.0 / (1.0 + torch.exp(-x))


def logit(p):
    return torch.log(p) - torch.log1p(-p)


def softplus(x):
    """log(1 + e^x) = logaddexp(x, 0), stable for large |x|."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def expand_scalar(x, shape, dtype=np.float32):
    """Broadcast a scalar (or compatible array) hyperparameter to `shape`.

    Returns a host numpy array: hyperparameters are static model config.
    """
    x = np.asarray(x, dtype=dtype)
    return np.broadcast_to(x, shape).copy()


def expand_cov(sigma, shape):
    """Broadcast a covariance hyperparameter to a (..., B, B) array.

    Accepts a scalar variance, a (B,) diagonal, a (B, B) matrix, or a fully
    specified (..., B, B) array.
    """
    B = shape[-1]
    if shape[-2] != B:
        raise ValueError(f"covariance shape must end in (B, B), got {shape}")
    sigma = np.asarray(sigma, dtype=np.float32)
    if sigma.ndim == 0:
        cov = sigma * np.eye(B, dtype=np.float32)
    elif sigma.ndim == 1:
        if sigma.shape != (B,):
            raise ValueError(f"diagonal covariance must be ({B},), "
                             f"got {sigma.shape}")
        cov = np.diag(sigma).astype(np.float32)
    else:
        cov = sigma.astype(np.float32)
    return np.broadcast_to(cov, shape).copy()


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises if it is a card and none is
    present, rather than running silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyglm_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Run cuBLAS float32 matmuls and einsums in full float32 inside the
    block, whatever the caller set (``allow_tf32``, ``fp32_precision`` or
    ``set_float32_matmul_precision``), and restore the caller's setting on
    exit, also after an exception. The JAX package pins each GEMM's
    precision per call; PyTorch reads a process-wide flag. Usable as a
    decorator.

    The caller's setting is read through the API it was set by: newer
    PyTorch raises when the legacy getter reads a value set through the
    per-backend ``fp32_precision``."""
    matmul = torch.backends.cuda.matmul
    try:
        saved = torch.get_float32_matmul_precision()
    except RuntimeError:          # set through matmul.fp32_precision
        saved = None
    if saved is None:
        prev = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = prev
    else:
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved)

