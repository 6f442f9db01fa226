"""The API surface of the ``pypolyagamma`` package on the port's samplers
(PyTorch counterpart of ``pyglm_tpu/compat/pypolyagamma.py``): a stateful
``PyPolyaGamma(seed)`` with ``pgdraw`` / ``pgdrawv``, and module-level
``pgdrawv`` and ``pgdrawvpar``.

A vector draw is one call of the vectorised samplers on the object's
`device` (the card unless the caller asks for the CPU): kernel K1 where
every b is 1 (``pg_draw_unit``), else the hybrid ``polya_gamma`` (K1 where
b = 1, K4 elsewhere). ``pgdrawvpar`` keeps the reference's OpenMP
static-schedule semantics: the vector splits into contiguous chunks, one
per generator, and each chunk draws from its own generator's stream. `out`
is filled in place (numpy), as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from pyglm_tpu_torch.ops.polyagamma import pg_draw_unit, polya_gamma
from pyglm_tpu_torch.utils.utils import require_device


class PyPolyaGamma:
    """Stateful PG sampler handle. Its stream is a CPU generator seeded
    `seed`: on the card it draws the kernels' Philox seeds, on the CPU the
    plain samplers draw on it."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = require_device(device)
        self.generator = torch.Generator()
        self.generator.manual_seed(int(seed) % (2 ** 31))

    def pgdraw(self, n, z) -> float:
        """One PG(n, z) draw."""
        return float(self.pgdrawv(np.asarray([n]), np.asarray([z]))[0])

    def pgdrawv(self, ns, zs, out=None):
        """PG(n_i, z_i) draws, numpy float32; fills `out` in place if
        given (and returns it)."""
        ns = torch.as_tensor(np.asarray(ns, np.float32), device=self.device)
        zs = torch.as_tensor(np.asarray(zs, np.float32), device=self.device)
        if bool(torch.all(ns == 1.0)):
            res = pg_draw_unit(zs.contiguous(), self.generator)
        else:
            res = polya_gamma(ns, zs, self.generator)
        res = res.cpu().numpy()
        if out is not None:
            out[...] = res
            return out
        return res


def pgdrawv(ns, zs, out=None, seed: int = 0, device="cuda"):
    """One vector draw from a fresh ``PyPolyaGamma(seed)``."""
    return PyPolyaGamma(seed, device=device).pgdrawv(ns, zs, out)


def pgdrawvpar(ppgs, ns, zs, out=None):
    """The reference's per-thread signature: a list of PyPolyaGamma objects
    and the draw vectors. The vector splits into len(ppgs) contiguous
    chunks, chunk i drawn by ppgs[i] (so the same generators and inputs
    give the same draws, chunk by chunk); with no generator, a fresh
    ``PyPolyaGamma(0)`` draws all."""
    if not len(ppgs):
        return PyPolyaGamma(0).pgdrawv(ns, zs, out)
    ns = np.asarray(ns, np.float32)
    zs = np.asarray(zs, np.float32)
    if len(ppgs) == 1 or ns.shape[0] == 0:
        return ppgs[0].pgdrawv(ns, zs, out)
    bounds = np.linspace(0, ns.shape[0], len(ppgs) + 1).astype(int)
    res = np.concatenate([
        np.atleast_1d(ppg.pgdrawv(ns[lo:hi], zs[lo:hi]))
        for ppg, lo, hi in zip(ppgs, bounds[:-1], bounds[1:]) if hi > lo])
    if out is not None:
        out[...] = res
        return out
    return res
