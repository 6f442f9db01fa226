"""The port's chain-data mesh: fit_ensemble and fit_tempered on a
("chain", "time", "neuron") mesh of 2 x 2 x 1 ranks under gloo on the CPU
(models/ensemble.py::make_stacked_sweep_gspmd,
models/tempering.py::make_tempered_sweep_gspmd): the stacked lanes over
("chain", "neuron"), the sums over "time".

The world is spawned once, in a module-scoped fixture, and runs
tests/torch_mesh_workers.py::chain_rank; the cases read its results.
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.parallel import sharding as S

import torch_mesh_workers as wk

KIND, WORLD = "chain_data", 4


@pytest.fixture(scope="module")
def res():
    return S.spawn(wk.chain_rank, WORLD, args=(KIND,), device="cpu",
                   timeout_s=300)


def test_ranks_hold_their_coordinates(res):
    assert [tuple(r["coords"].values()) for r in res] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]


def test_initial_states_equal_unsharded(res):
    assert all(r["init_equal"] for r in res)


@pytest.mark.parametrize("field", ["A_mean", "Weff_mean", "lls"])
def test_results_are_global_and_equal_on_every_rank(res, field):
    for r in res:
        assert np.array_equal(r["mean"][field], res[0]["mean"][field])
    assert res[0]["mean"]["A_mean"].shape == (4, 8, 8)
    assert np.all(np.isfinite(res[0]["mean"]["lls"]))


def test_collect_mean_equals_mean_of_samples(res):
    for r in res:
        m, s = r["mean"], r["samples"]
        assert np.array_equal(m["lls"], s["lls"])
        np.testing.assert_allclose(m["A_mean"], s["A"].mean(axis=1),
                                   atol=1e-6)
        assert m["rhat_ll"] == s["rhat_ll"] and np.isfinite(m["rhat_ll"])


def test_stacked_update_on_the_mesh_equals_unsharded(res):
    """The spike-and-slab update of 4 stacked chains (32 lanes, blocks of
    16 straddling no chain boundary here, summed over 2 time ranks) on the
    same omega and noise as the unsharded stacked update: A identical, w
    within 1e-5, the mesh-fused loop."""
    for r in res:
        u = r["update"]
        assert u["path"] == "mesh_fused"
        assert torch.equal(u["A_s"], u["A_u"])
        assert float((u["w_s"] - u["w_u"]).abs().max()) <= 1e-5


def test_nb_ensemble_on_the_mesh(res):
    """The NB family's dispersion update without a count table on the
    mesh (the CRT counts of each rank's tile, summed over "time", r drawn
    at full width): finite, positive and the same on every rank."""
    for r in res:
        nb = r["nb"]
        assert np.all(np.isfinite(nb["lls"])) and nb["r"].shape == (4, 16)
        assert np.all(nb["r"] > 0)
        assert np.array_equal(nb["r"], res[0]["nb"]["r"])
        assert np.array_equal(nb["lls"], res[0]["nb"]["lls"])


@pytest.mark.parametrize("case", ["nb_table", "nb_crt", "gaussian"])
def test_aux_update_on_the_mesh_equals_unsharded(res, case):
    """The auxiliary updates of 64 stacked lanes (each rank's block of 32
    over ("chain", "neuron"), rows over 2 time ranks) against the
    unsharded update on the same inputs and replicated generator state
    (tests/torch_mesh_workers.py::_aux_case); NB's r without a count
    table is the stacked sweep's path."""
    for r in res:
        got, want, lockstep = r["aux"][case]
        assert lockstep and got.shape == (32,)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_tempered_swap_on_the_mesh(res):
    for r in res:
        t = r["tempered"]
        assert t["equal"] and t["parity"][0] == t["parity"][1]
        assert all(torch.equal(a, b) for a, b in
                   zip(t["rep_state"], res[0]["tempered"]["rep_state"]))


def test_fit_tempered_on_the_mesh(res):
    for r in res:
        f = r["fit_tempered"]
        assert np.all(np.isfinite(f["lls"]))
        assert np.all((f["swap_rate"] >= 0) & (f["swap_rate"] <= 1))
        assert np.array_equal(f["lls"], res[0]["fit_tempered"]["lls"])


@pytest.mark.parametrize("name,match", [
    ("not_a_mesh", "Mesh"), ("no_chain_axis", "chain"),
    ("unstacked", "stacked"), ("tempered_not_a_mesh", "Mesh"),
    ("indivisible", "divisible")])
def test_mesh_rules_raise_value_error(res, name, match):
    for r in res:
        assert r["errors"][name] is not None and match in r["errors"][name]
