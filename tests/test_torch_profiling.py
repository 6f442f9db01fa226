"""pyglm_tpu_torch/diagnostics/profiling.py on the CPU: PhaseTimer's phases
and report, force_sync, the torch.profiler trace file, and
sweep_breakdown's stages, which are the JAX package's stage keys for the
same model (spike-and-slab and dense)."""
import json

import numpy as np
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch as pt
from pyglm_tpu.diagnostics import profiling as jprof
from pyglm_tpu_torch.diagnostics import profiling as tprof

torch.set_num_threads(1)


def test_phase_timer():
    timer = tprof.PhaseTimer()
    with timer.phase("a"):
        np.ones(10)
    with timer.phase("b") as box:
        box["out"] = (torch.ones(10) * 2, {"x": torch.zeros(3)})
    with timer.phase("a"):
        pass
    assert list(timer.times) == ["a", "b"]
    assert all(v >= 0 for v in timer.times.values())
    rep = timer.report()
    assert "a" in rep and "b" in rep and "TOTAL" in rep
    x = torch.arange(3)
    assert tprof.force_sync(x) is x


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]


@pytest.mark.parametrize("spike_slab", [True, False])
def test_sweep_breakdown_stages_match_jax(spike_slab):
    kw = dict(B=2, L=4, seed=0, network="erdos_renyi",
              spike_and_slab=spike_slab)
    jm = pyglm_tpu.NonlinearAutoregressiveModel(6, **kw)
    jm.generate(512, keep=True)
    tm = pt.NonlinearAutoregressiveModel(6, device="cpu", **kw)
    tm.generate(512, keep=True)
    state0 = [x.clone() for x in (tm.state.A, tm.state.W, tm.state.b)]
    gen0 = tm.generators.host.get_state()
    times = tprof.sweep_breakdown(tm, n_reps=1)
    assert list(times) == list(jprof.sweep_breakdown(jm, n_reps=1))
    assert all(v >= 0 for v in times.values())
    # The model is untouched.
    for a, b in zip(state0, (tm.state.A, tm.state.W, tm.state.b)):
        assert torch.equal(a, b)
    assert torch.equal(gen0, tm.generators.host.get_state())
