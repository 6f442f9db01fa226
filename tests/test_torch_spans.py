"""The span recorder of pyglm_tpu_torch/diagnostics/profiling.py on the
CPU: off, ``span`` and ``wait`` return one shared no-op and record nothing,
and recording changes no draw; on, the single, stacked and tempered loops
record their stage tree (children inside parents, one step id a step,
``swap`` under ``tempered_sweep``), a fixed count of ``wait`` spans a step,
and the step's kernel-launch counts; the recording's paths, self times and
table; the build span and its counter."""
import types

import pytest
import torch

import pyglm_tpu_torch as pt
from pyglm_tpu_torch.diagnostics import profiling
from pyglm_tpu_torch.diagnostics.profiling import (
    NO_SPAN, count, recording, span, wait)
from pyglm_tpu_torch.models import observations
from pyglm_tpu_torch.models.ensemble import (
    chain_generators, ensemble_generators, make_stacked_sweep, stack_states)
from pyglm_tpu_torch.models.sweep import init_state_from_prior
from pyglm_tpu_torch.models.tempering import make_tempered_sweep
from pyglm_tpu_torch.ops import _build

torch.set_num_threads(1)
N, B, C = 6, 2, 2
LD = dict(hmc_steps=3, hmc_iters=2, swap_moves=1, relocate_moves=1)


def _single(seed=0):
    m = pt.NonlinearAutoregressiveModel(
        N, B=B, L=4, seed=seed, network="erdos_renyi", spike_and_slab=True,
        device="cpu")
    m.generate(300, keep=True)
    return lambda: m.resample_model(), lambda: (m.state, m.generators)


def _lanes(tempered: bool, seed=0):
    m = pt.NonlinearAutoregressiveModel(
        N, B=B, L=4, seed=seed, network="latent_distance",
        spike_and_slab=True, net_kwargs=LD, device="cpu")
    m.generate(300, keep=True)
    if tempered:
        sweep = make_tempered_sweep(m.observation, m.network, N, B,
                                    [0.5, 1.0], group=m.group,
                                    precision=m.precision)
    else:
        sweep = make_stacked_sweep(m.observation, m.network, N, B, C, True,
                                   group=m.group, precision=m.precision)
    box = [stack_states([init_state_from_prior(
        ensemble_generators(sd, "cpu"), m.observation, m.network, N, B,
        True, "cpu") for sd in range(1, C + 1)])]
    gens = chain_generators(seed + 99, "cpu")
    datas = tuple(m.datas)

    def step():
        box[0], _ = sweep(gens, box[0], datas)
    return step, lambda: (box[0], gens)


LOOPS = {"single": _single,
         "stacked": lambda seed=0: _lanes(False, seed),
         "tempered": lambda seed=0: _lanes(True, seed)}

HYPERS = {"hypers", "hypers/wait.prior_lam", "hypers/wait.prior_mu"}
STAGES = {"psi", "pg_draws", "weights", "weights/gram", "aux", "network",
          "network/wait.weight_stats", "network/niw", "loglik"}
LANE_NET = {"network/hmc", "network/swap_scan", "network/relocate_scan"}
TREES = {
    "single": {"resample_model", "wait.diag", "hypers/wait.logit_rho",
               "network/beta"} | HYPERS | STAGES,
    "stacked": {"stacked_sweep"} | HYPERS | STAGES | LANE_NET,
    "tempered": {"tempered_sweep", "stacked_sweep", "swap", "swap/wait.lls"}
    | {"stacked_sweep/" + p for p in HYPERS | STAGES | LANE_NET},
}
# wait spans a step: the weight prior's Lam and mu for each chain, the
# active-weight statistics; the single chain's logit rho and its two
# diagnostics; the tempered sweep's log-likelihoods (its permutation
# crosses no device on the CPU).
WAITS = {"single": 6, "stacked": 2 * C + 1, "tempered": 2 * C + 2}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


def test_off_returns_the_shared_no_op_and_records_nothing():
    assert profiling._ACTIVE is None
    assert span("a") is NO_SPAN and span("a", step=True) is NO_SPAN
    assert wait("a") is NO_SPAN
    with span("a") as s, wait("b"):
        assert s is NO_SPAN
    count("kernel_builds")
    step, _ = _single()
    step()
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.steps == [] and rec.counts == {}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_recording_changes_no_draw(loop):
    runs = []
    for on in (False, True):
        step, state = LOOPS[loop]()
        if on:
            with recording():
                step()
                step()
        else:
            step()
            step()
        st, gens = state()
        runs.append(_leaves(st) + [gens.device.get_state(),
                                   gens.host.get_state()])
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_each_loop_records_its_stage_tree(loop):
    step, _ = LOOPS[loop]()
    step()
    with recording() as rec:
        step()
        step()
    assert [s["name"] for s in rec.steps] == [
        {"single": "resample_model"}.get(loop, loop + "_sweep")] * 2
    assert {rec.path(i) for i in range(len(rec.spans))} == TREES[loop]
    for i, (name, parent, stp, s, e) in enumerate(rec.spans):
        assert s <= e
        assert stp in (0, 1)                # every span is in a step
        if parent < 0:
            assert rec.steps[stp]["span"] == i
        else:
            _, _, pstep, ps, pe = rec.spans[parent]
            assert pstep == stp and ps <= s and e <= pe
    for k, st in enumerate(rec.steps):
        assert rec.spans[st["span"]][2] == k
        assert st["waits"] == WAITS[loop] == sum(
            1 for name, _, stp, _, _ in rec.spans
            if stp == k and name.startswith("wait."))
    if loop == "tempered":
        swap = [i for i, sp in enumerate(rec.spans) if sp[0] == "swap"]
        assert [rec.spans[rec.spans[i][1]][0] for i in swap] == [
            "tempered_sweep"] * 2


def test_launch_counts_are_attached_to_the_step(monkeypatch):
    draw = observations.pg_draw_unit

    def counted(c, generator):
        _build.LAUNCHES["pg_devroye"] += 1
        return draw(c, generator)
    monkeypatch.setattr(observations, "pg_draw_unit", counted)
    step, _ = _single()
    with recording() as rec:
        step()
        step()
    assert [s["launches"] for s in rec.steps] == [{"pg_devroye": 1}] * 2


def test_paths_self_times_and_table():
    with recording() as rec:
        with span("setup"):
            with wait("x"):
                pass
        with span("loop", step=True):
            with span("inner", step=True):      # a stage of the outer step
                with span("leaf"):
                    pass
            with wait("y"):
                pass
    names = [s[0] for s in rec.spans]
    assert names == ["setup", "wait.x", "loop", "inner", "leaf", "wait.y"]
    assert [rec.path(i) for i in range(6)] == [
        "setup", "setup/wait.x", "loop", "inner", "inner/leaf", "wait.y"]
    assert [s[2] for s in rec.spans] == [-1, -1, 0, 0, 0, 0]
    assert rec.steps == [{"name": "loop", "span": 2, "waits": 1,
                          "launches": {}}]
    own = rec.self_ns()
    dur = [e - s for *_, s, e in rec.spans]
    assert own[2] == dur[2] - dur[3] - dur[5]
    assert own[3] == dur[3] - dur[4] and own[4] == dur[4]
    rows = {p: (n, tot, slf) for p, n, tot, slf in rec.table()}
    assert rows["inner"] == (1, dur[3], own[3])
    assert [r[3] for r in rec.table()] == sorted(own, reverse=True)
    with pytest.raises(RuntimeError, match="already on"):
        with recording():
            with recording():
                pass
    assert profiling._ACTIVE is None


@pytest.mark.parametrize("seconds,builds", [(0.0, 0), (12.5, 1)])
def test_the_library_load_is_the_build_span(monkeypatch, seconds, builds):
    class Lib:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "build", lambda: seconds)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    _build.library.cache_clear()
    try:
        with recording() as rec:
            _build.library()
            _build.library()                # loaded once
    finally:
        _build.library.cache_clear()
    assert [s[0] for s in rec.spans] == ["build"]
    assert rec.counts == {"kernel_builds": builds}
