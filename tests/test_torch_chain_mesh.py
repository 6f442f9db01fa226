"""The port's chain mesh: fit_ensemble and fit_tempered with chains (rungs)
spread over a ("chain",) mesh of 2 ranks under gloo on the CPU
(models/ensemble.py::make_stacked_sweep_sharded,
models/tempering.py::make_tempered_sweep_sharded).

The world is spawned once, in a module-scoped fixture, and runs
tests/torch_mesh_workers.py::chain_rank; the cases read its results.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.parallel import sharding as S

import torch_mesh_workers as wk

KIND, WORLD = "chain", 2


@pytest.fixture(scope="module")
def res():
    return S.spawn(wk.chain_rank, WORLD, args=(KIND,), device="cpu",
                   timeout_s=300)


def test_ranks_hold_their_chain_coordinate(res):
    assert [r["coords"] for r in res] == [{"chain": 0}, {"chain": 1}]


def test_initial_states_equal_unsharded(res):
    """Chain c starts from ensemble_generators(seeds[c]) on every mesh."""
    assert all(r["init_equal"] for r in res)


@pytest.mark.parametrize("field", ["A_mean", "Weff_mean", "lls"])
def test_results_are_global_and_equal_on_every_rank(res, field):
    for r in res:
        assert np.array_equal(r["mean"][field], res[0]["mean"][field])
    assert res[0]["mean"]["A_mean"].shape == (4, 8, 8)
    assert res[0]["mean"]["lls"].shape == (4, 4)
    assert np.all(np.isfinite(res[0]["mean"]["lls"]))


def test_collect_mean_equals_mean_of_samples(res):
    """collect="mean" and "samples" from the same seeds on the mesh: the
    same chains, so the means agree and the lls are identical."""
    for r in res:
        m, s = r["mean"], r["samples"]
        assert np.array_equal(m["lls"], s["lls"])
        np.testing.assert_allclose(m["A_mean"], s["A"].mean(axis=1),
                                   atol=1e-6)
        Weff = s["W"].sum(axis=-1).mean(axis=1)
        np.testing.assert_allclose(m["Weff_mean"], Weff, atol=1e-5)
        assert m["rhat_ll"] == s["rhat_ll"] and np.isfinite(m["rhat_ll"])


def test_tempered_swap_moves_gathered_states(res):
    """A tempered sweep on the mesh equals its pass run apart, the states
    gathered and permuted by swap_permutation on the same parity bit and
    uniforms; each rank keeps its slice; the replicated generator is in
    lockstep on every rank."""
    for r in res:
        t = r["tempered"]
        assert t["equal"] and t["local_is_slice"]
        assert t["parity"][0] == t["parity"][1]
        assert all(torch.equal(a, b) for a, b in
                   zip(t["rep_state"], res[0]["tempered"]["rep_state"]))


def test_fit_tempered_on_the_mesh(res):
    for r in res:
        f = r["fit_tempered"]
        assert f["A"].shape == (4, 8, 8) and np.all(np.isfinite(f["lls"]))
        assert np.all((f["swap_rate"] >= 0) & (f["swap_rate"] <= 1))
        assert np.array_equal(f["lls"], res[0]["fit_tempered"]["lls"])


@pytest.mark.parametrize("name,match", [
    ("not_a_mesh", "Mesh"), ("no_chain_axis", "chain"),
    ("unstacked", "stacked"), ("tempered_not_a_mesh", "Mesh"),
    ("indivisible", "divisible")])
def test_mesh_rules_raise_value_error(res, name, match):
    for r in res:
        assert r["errors"][name] is not None and match in r["errors"][name]
