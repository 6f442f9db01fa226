"""The system under test: pyglm_tpu_torch's chain, built from a cell's
configuration and traffic mix and driven one step at a time.

A traffic mix names its loop:
  "single"    one chain: ``model.resample_model()``, one Gibbs sweep;
  "stacked"   C chains as one lane-stacked sweep, the step that
              ``fit_ensemble(n_chains=C)`` runs;
  "tempered"  C rungs on a fixed ladder ``betas``: the tempered sweep and
              the swap, the step that ``fit_tempered(betas=...)`` runs.

``capture()`` runs one more step through the same call and records what
the reference needs to judge it: the state before and after, the
generators' states, and the program's own psi, omega and network-update
inputs, read where the sweep passes them to the observation family and
the network prior.
"""
from __future__ import annotations

import torch

from gibbsbench.simulate import sub_seeds


def _clone(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


class _Recorder:
    """Wraps the family's omega_kappa and the prior's resample on their
    instances while one step runs, keeping what they were given and
    returned and the generators' states on entry."""

    def __init__(self, obs, net):
        self.obs, self.net, self.rec = obs, net, {}

    def __enter__(self):
        obs, net, rec = self.obs, self.net, self.rec
        ok, tok, rs = obs.omega_kappa, obs.tempered_omega_kappa, net.resample

        def omega_kappa(generator, Y, psi, aux):
            omega, kappa = ok(generator, Y, psi, aux)
            rec.update(psi=psi, omega=omega)
            return omega, kappa

        def tempered_omega_kappa(generator, Y, psi, aux, beta):
            omega, kappa = tok(generator, Y, psi, aux, beta)
            rec.update(psi=psi, omega=omega)
            return omega, kappa

        def resample(gens, state, A, W, *a, **k):
            rec.setdefault("net_calls", []).append(dict(
                dev_gen=gens.device.get_state(),
                host_gen=gens.host.get_state(), A=A.clone(), W=W.clone()))
            return rs(gens, state, A, W, *a, **k)

        for o, name, fn in ((obs, "omega_kappa", omega_kappa),
                            (obs, "tempered_omega_kappa",
                             tempered_omega_kappa),
                            (net, "resample", resample)):
            object.__setattr__(o, name, fn)
        return rec

    def __exit__(self, *exc):
        for o, name in ((self.obs, "omega_kappa"),
                        (self.obs, "tempered_omega_kappa"),
                        (self.net, "resample")):
            o.__dict__.pop(name, None)


def _model(cfg: dict, seed: int, precision: str, device, Y):
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    m = NonlinearAutoregressiveModel(
        cfg["N"], B=cfg["B"], L=cfg["L"], observation=cfg["observation"],
        network=cfg["network"], spike_and_slab=cfg["spike_and_slab"],
        seed=seed, precision=precision, group=cfg["group"], device=device,
        net_kwargs=dict(cfg["prior"]))
    m.add_data(Y)
    return m


class System:
    """One chain (or C stacked chains) of the program on the cell's data.
    `chains`: chain-sweeps a step counts."""

    def __init__(self, cfg: dict, traffic: dict, Y, seed: int, device,
                 precision: str | None = None):
        self.loop = traffic["loop"]
        self.chains = int(traffic.get("chains", 1))
        self.precision = precision or cfg["precision"]
        s_model, s_chains, s_sweep = sub_seeds(seed + 0x51, 3)
        self.model = _model(cfg, s_model, self.precision, device, Y)
        m = self.model
        self.betas = None
        if self.loop == "single":
            return
        from pyglm_tpu_torch.models.ensemble import (
            chain_generators, ensemble_generators, make_stacked_sweep,
            stack_states)
        from pyglm_tpu_torch.models.sweep import init_state_from_prior
        C = self.chains
        seeds = sub_seeds(s_chains, C)
        self.gens = chain_generators(s_sweep, device)
        self.st = stack_states([init_state_from_prior(
            ensemble_generators(sd, device), m.observation, m.network, m.N,
            m.B, m.spike_and_slab, device) for sd in seeds])
        self.datas = tuple(m.datas)
        if self.loop == "stacked":
            self._sweep = make_stacked_sweep(
                m.observation, m.network, m.N, m.B, C, m.spike_and_slab,
                group=m.group, precision=self.precision)
        elif self.loop == "tempered":
            from pyglm_tpu_torch.models.tempering import make_tempered_sweep
            self.betas = [float(b) for b in traffic["betas"]]
            if len(self.betas) != C:
                raise ValueError(f"{len(self.betas)} betas for {C} rungs")
            self._sweep = make_tempered_sweep(
                m.observation, m.network, m.N, m.B, self.betas,
                m.spike_and_slab, group=m.group, precision=self.precision)
        else:
            raise ValueError(f"unknown loop {self.loop!r}")

    def step(self):
        if self.loop == "single":
            self.model.resample_model()
        else:
            self.st, _ = self._sweep(self.gens, self.st, self.datas)

    def _state_gens(self):
        if self.loop == "single":
            return self.model.state, self.model.generators
        return self.st, self.gens

    def capture(self) -> dict:
        """One more step, recorded for the reference."""
        st, gens = self._state_gens()
        pre = _clone(st)
        dev_gen = gens.device.get_state()
        swap = {}
        if self.loop == "tempered":
            from pyglm_tpu_torch.models import tempering
            sp, ps = tempering.swap_permutation, tempering.permute_states

            def swap_permutation(generator, lls, betas, *a, **k):
                swap.update(host_gen=generator.get_state())
                return sp(generator, lls, betas, *a, **k)

            def permute_states(s, perm):
                swap.setdefault("unswapped", _clone(s))
                return ps(s, perm)
            tempering.swap_permutation = swap_permutation
            tempering.permute_states = permute_states
        try:
            with _Recorder(self.model.observation, self.model.network) as rec:
                self.step()
        finally:
            if self.loop == "tempered":
                tempering.swap_permutation = sp
                tempering.permute_states = ps
        post = _clone(self._state_gens()[0])
        return dict(rec, pre=pre, post=post, dev_gen=dev_gen,
                    swap=swap or None, chains=self.chains, betas=self.betas)
