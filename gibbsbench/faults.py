"""Faults planted in the program, each at the stage where its answer is
produced, to read the upper end of a compared number's limit (calibrate.py
on the card, at a cell's own size) and to see ``correct`` come out false
(tests/test_gibbsbench_faults.py on the CPU). The benchmark's own runs
plant nothing.

  state_unchanged  the weight update returns the weights it was given
  half_rows        the weight update sees half of the bins, its sums
                   doubled (the mean over the rest stands for the whole)
  psi_bf16         psi formed from weights rounded to bfloat16
  pg_scaled        every Polya-gamma draw 25% too large
  pg_spread        every Polya-gamma draw's distance from its mean shrunk
                   by 30%: the mean kept, the spread wrong
  net_unchanged    the network move returns the state it was given
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_rows", "psi_bf16", "pg_scaled",
          "pg_spread", "net_unchanged")


def _update_unchanged(real):
    def update(generator, Xt, omega, kappa, psi, w_full, hyp, B, **kw):
        N_pre = (w_full.shape[0] - 1) // B
        A = (w_full[:-1].reshape(N_pre, B, -1).abs().sum(1) > 0).float()
        return A, w_full.clone(), kappa - omega * psi, omega.sum(0)
    return update


def _update_half_rows(real):
    def update(generator, Xt, omega, kappa, psi, w_full, hyp, B, **kw):
        h = omega.shape[0] // 2
        A, w, _, s = real(generator, Xt[:, :h].contiguous(), 2 * omega[:h],
                          2 * kappa[:h], psi[:h], w_full, hyp, B, **kw)
        return A, w, kappa - omega * (Xt.T @ w), s
    return update


def _pack_bf16(real):
    def pack(A, W, b):
        return real(A, W, b).to(torch.bfloat16).to(torch.float32)
    return pack


def _pg_scaled(real):
    def draw(c, generator, *a, **k):
        return 1.25 * real(c, generator, *a, **k)
    return draw


def _pg_spread(real):
    def draw(c, generator, *a, **k):
        omega = real(c, generator, *a, **k)
        c = c.abs().clamp_min(1e-3)
        mean = torch.tanh(c / 2) / (2 * c)
        return mean + 0.7 * (omega - mean)
    return draw


def _unchanged_move(real):
    def resample(self, gens, state, A, W, *a, **k):
        return state
    return resample


def _targets(name):
    """[(object, attribute, wrapper)] of fault `name`."""
    from pyglm_tpu_torch.models import ensemble, networks, observations
    from pyglm_tpu_torch.models import sweep
    if name == "state_unchanged":
        return [(m, "resample_spike_slab_tspace", _update_unchanged)
                for m in (sweep, ensemble)]
    if name == "half_rows":
        return [(m, "resample_spike_slab_tspace", _update_half_rows)
                for m in (sweep, ensemble)]
    if name == "psi_bf16":
        return [(m, "pack_weights", _pack_bf16) for m in (sweep, ensemble)]
    if name == "pg_scaled":
        return [(observations, "pg_draw_unit", _pg_scaled)]
    if name == "pg_spread":
        return [(observations, "pg_draw_unit", _pg_spread)]
    if name == "net_unchanged":
        return [(cls, "resample", _unchanged_move) for cls in
                (networks.ErdosRenyiConfig, networks.LatentDistanceConfig)]
    raise ValueError(f"unknown fault {name!r}: one of {FAULTS}")


@contextlib.contextmanager
def plant(name: str | None):
    """Plant fault `name` (None: nothing) for the block."""
    targets = [] if name is None else _targets(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    try:
        for (obj, attr, wrap), (_, _, real) in zip(targets, saved):
            setattr(obj, attr, wrap(real))
        yield
    finally:
        for obj, attr, real in saved:
            setattr(obj, attr, real)
