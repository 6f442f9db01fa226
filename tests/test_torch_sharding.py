"""The port's ("time", "neuron") meshes (pyglm_tpu_torch/parallel/sharding.py)
against the JAX package's and against the unsharded port.

Ranks run on the CPU under gloo: each world (2 ranks: meshes (2, 1) and
(1, 2); 4 ranks: (2, 2) and (4, 1)) is spawned once, in a module-scoped
fixture, and runs all of its work in tests/torch_mesh_workers.py; the
cases below read what the ranks returned. The JAX side runs here, on the
conftest's 8 simulated CPU devices.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import pyglm_tpu.parallel.sharding as js
from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops import basis as jb
from pyglm_tpu_torch.ops.ss_cuda import unpack_gram
from pyglm_tpu_torch.parallel import sharding as S

import torch_mesh_workers as wk

MESHES = [(2, 1), (1, 2), (2, 2), (4, 1)]
WORLD = {(2, 1): 2, (1, 2): 2, (2, 2): 4, (4, 1): 4}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ck")
    return {n: S.spawn(wk.sharding_rank, n, args=(str(d),), device="cpu",
                       timeout_s=300)
            for n in (2, 4)}


def ranks(worlds, shape):
    """Every rank's results for mesh `shape`."""
    return [r[shape] for r in worlds[WORLD[shape]]]


# ---------------------------------------------------------------------------
# Layouts (no processes)
# ---------------------------------------------------------------------------

def _jax_coords(jmesh, r):
    """The coordinates of device r in a JAX mesh."""
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    return dict(zip(jmesh.axis_names,
                    (int(c[0]) for c in np.nonzero(ids == r))))


@pytest.mark.parametrize("kind,args", [
    ("data", (1, 8)), ("data", (2, 4)), ("data", (4, 2)), ("data", (8, 1)),
    ("chain", (4,)), ("chain", (8,)),
    ("chain_data", (2, 2, 2)), ("chain_data", (2, 4, 1)),
    ("chain_data", (4, 1, 2))])
def test_mesh_layout_matches_jax(kind, args):
    """Rank r holds the coordinates of device r of the JAX mesh of the same
    shape, and the lane index / count of JAX's lane axes."""
    devs = jax.devices()
    n = int(np.prod(args))
    if kind == "data":
        jm = js.make_mesh(*args, devices=devs[:n])
        shape = dict(zip(("time", "neuron"), args))
    elif kind == "chain":
        jm = js.make_chain_mesh(args[0], devices=devs[:n])
        shape = {"chain": args[0]}
    else:
        jm = js.make_chain_data_mesh(*args, devices=devs[:n])
        shape = dict(zip(("chain", "time", "neuron"), args))
    for r in range(n):
        m = S.Mesh(tuple(shape), tuple(shape.values()), rank=r)
        assert m.shape == dict(jm.shape)
        assert m.coords == _jax_coords(jm, r)
        assert S.lane_axes(m) == js.lane_axes(jm)
        assert S.lane_count(m) == js.lane_count(jm)


@pytest.mark.parametrize("N", [16, 27, 500])
@pytest.mark.parametrize("T", [256, 384, None])
def test_best_mesh_for_matches_jax(N, T):
    devs = jax.devices()
    for k in range(1, 9):
        want = js.best_mesh_for(N, T=T, devices=devs[:k]).shape
        got = S.best_mesh_for(N, T=T, devices=k).shape
        assert got == dict(want), (N, T, k)


def test_mesh_builders_reject_bad_shapes():
    with pytest.raises(ValueError):
        S.make_mesh(3, 1, devices=4)
    with pytest.raises(ValueError):
        S.make_chain_mesh(5, devices=4)
    with pytest.raises(ValueError):
        S.make_chain_data_mesh(2, 2, 2, devices=4)
    with pytest.raises(ValueError):
        S.Mesh(("neuron", "time"), (1, 1))
    with pytest.raises(ValueError):
        S.glm_shardings(S.Mesh(S.DATA_AXES, (1, 2), rank=1), 10, 5)
    lay = S.glm_shardings(S.Mesh(S.DATA_AXES, (2, 2), rank=3), 10, 4, L=3)
    assert (lay.rows, lay.lanes, lay.whole) == (slice(5, 10), slice(2, 4),
                                                False)
    lay = S.glm_shardings(S.Mesh(S.DATA_AXES, (2, 2), rank=3), 11, 4)
    assert (lay.rows, lay.whole) == (slice(0, 11), True)
    with pytest.raises(ValueError, match="process groups"):
        S.require_mesh(S.Mesh(S.DATA_AXES, (1, 1)))
    with pytest.raises(ValueError, match="Mesh"):
        S.require_mesh(object())


# ---------------------------------------------------------------------------
# Design, Grams and statistics against the JAX package
# ---------------------------------------------------------------------------

def _jax_data_mesh(shape):
    return js.make_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)])
def test_design_matrix_sharded_matches_jax_bitwise(worlds, shape):
    """Each time rank's rows of the design equal the same rows of the JAX
    package's design_matrix_sharded, bit for bit (2 and 4 time ranks)."""
    Y = wk.spikes()
    want = np.asarray(jb.design_matrix_sharded(
        jax.numpy.asarray(Y), jb.cosine_basis(B=wk.B, L=wk.L),
        _jax_data_mesh(shape)))
    for r in ranks(worlds, shape):
        assert np.array_equal(r["design"].numpy(), want[r["rows"]])


@pytest.mark.parametrize("shape", MESHES)
def test_design_matrix_sharded_rejections(worlds, shape):
    """Unequal time blocks (T not divisible by the time axis) and blocks
    shorter than L raise ValueError, as the JAX package asserts."""
    for r in ranks(worlds, shape):
        msgs = r["design_err"]
        assert all(m is not None for m in msgs), msgs
        if shape[0] > 1:
            assert "not divisible" in msgs[0]
        assert "shorter than the basis filter" in msgs[-1]


@pytest.mark.parametrize("shape", MESHES)
def test_group_gram_sharded_matches_jax(worlds, shape):
    """The time-summed group Gram of each rank's lanes against the JAX
    package's _gram_shard_map on its mesh (rtol 1e-5)."""
    Y, om = wk.gram_inputs()
    Xf = jb.design_matrix(jax.numpy.asarray(Y),
                          jb.cosine_basis(B=wk.B, L=wk.L))
    want = np.asarray(jw._gram_shard_map(
        Xf, jax.numpy.asarray(om), wk.B, wk.G, 512, "highest",
        _jax_data_mesh(shape), False))                   # (Ng, N, GB, GB)
    GB = wk.G * wk.B
    for r in ranks(worlds, shape):
        got = torch.stack([unpack_gram(j, GB) for j in r["gram"]]).numpy()
        np.testing.assert_allclose(got, want[:, r["lanes"]], rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", MESHES)
def test_sufficient_stats_sharded_matches_jax(worlds, shape):
    Y, om = wk.gram_inputs()
    Xf = jb.design_matrix(jax.numpy.asarray(Y),
                          jb.cosine_basis(B=wk.B, L=wk.L))
    o = jax.numpy.asarray(om)
    J, h = map(np.asarray, jw.sufficient_stats(Xf, o, o))
    for r in ranks(worlds, shape):
        Jl, hl = (x.numpy() for x in r["stats"])
        ln = r["lanes"]
        np.testing.assert_allclose(Jl, J[ln], rtol=1e-5,
                                   atol=1e-5 * np.abs(J).max())
        np.testing.assert_allclose(hl, h[:, ln], rtol=1e-5,
                                   atol=1e-5 * np.abs(h).max())


# ---------------------------------------------------------------------------
# The updates against the unsharded port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [("fused", "high"), ("staged", "high"),
                                  ("fused", "default"),
                                  ("staged", "highest")])
def test_spike_slab_update_sharded_equals_unsharded(worlds, shape, case):
    """Given the same omega and noise, the mesh update of each loop gives
    the unsharded update's A on the rank's lanes, and w within 1e-5: the
    time ranks' sums differ only in fp32 order."""
    for r in ranks(worlds, shape):
        u = r["update"][case]
        assert u["path"] == "mesh_" + case[0]
        if shape[0] == 1:
            # no time split: the unsharded update on the rank's lanes
            # alone does the same sums in the same order
            assert u["block_equal"]
        assert torch.equal(u["A_s"], u["A_u"])
        assert float((u["w_s"] - u["w_u"]).abs().max()) <= 1e-5
        assert float((u["u_s"] - u["u_u"]).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", MESHES)
def test_dense_update_sharded_equals_unsharded(worlds, shape):
    """The dense update on a mesh against the unsharded one on the same
    omega and normals. J sums T in one GEMM unsharded and per time rank
    on a mesh, so w (the bias near 2.6) may differ by fp32 rounding of
    that order: atol 1e-5 plus rtol 1e-5; exact without a time split."""
    for r in ranks(worlds, shape):
        u = r["update_dense"]
        if shape[0] == 1:
            assert torch.equal(u["w_s"], u["w_u"])
        torch.testing.assert_close(u["w_s"], u["w_u"], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_pg_draws_on_a_mesh_are_the_ranks_tiles(worlds, shape):
    """pg_draw_unit / polya_gamma with mesh= draw each rank's tile on its
    shard generator and gather the whole, the same on every rank."""
    rs = ranks(worlds, shape)
    for r in rs:
        assert r["pg"]["tile_ok"] and r["pg"]["tile_b_ok"]
        assert torch.equal(r["pg"]["whole"], rs[0]["pg"]["whole"])
        assert bool((r["pg"]["whole"] > 0).all())


# ---------------------------------------------------------------------------
# Sweeps of the sharded model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", wk.SWEEP_KINDS,
                         ids=["-".join(map(str, k)) for k in wk.SWEEP_KINDS])
def test_sharded_sweeps_run_every_family_and_prior(worlds, shape, kind):
    """3 sharded sweeps at N=16, T=256: finite, the same diagnostics and
    state on every rank, and the replicated generators in lockstep."""
    rs = [r["sweeps"][kind] for r in ranks(worlds, shape)]
    for r in rs:
        assert np.all(np.isfinite(r["lls"]))
        assert r["A"].shape == (wk.N, wk.N)
        assert r["lls"] == rs[0]["lls"] and r["n_edges"] == rs[0]["n_edges"]
        assert np.array_equal(r["A"], rs[0]["A"])
        assert np.array_equal(r["bias"], rs[0]["bias"])
        assert all(torch.equal(a, b) for a, b in zip(r["gens"],
                                                     rs[0]["gens"]))
    if kind[2]:
        want = ("mesh_staged" if kind[0] == "gaussian" else "mesh_fused")
        assert rs[0]["path"] == want


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", wk.SWEEP_KINDS,
                         ids=["-".join(map(str, k)) for k in wk.SWEEP_KINDS])
def test_sharded_sweeps_equal_unsharded(worlds, shape, kind):
    """With the PG draws replaced by their means, 2 sharded sweeps of each
    family and prior and 2 unsharded sweeps of the same model draw the
    same replicated numbers: the same A, and W, bias, the family's aux,
    the network state and the log-likelihoods within the fp32 order of
    the time ranks' sums, carried through two sweeps (at most 2.7e-5 on
    a dense W, 1.3e-4 on a dense NB bias near -2, 8e-6 relative on r);
    the replicated generators end equal to the unsharded model's."""
    for r in ranks(worlds, shape):
        s = r["sweeps_vs_unsharded"][kind]
        assert s["gens"]
        assert np.array_equal(*s["A"])
        for k in ("W", "bias"):
            np.testing.assert_allclose(*s[k], rtol=1e-4, atol=5e-5,
                                       err_msg=k)
        for k, (got, want) in (s["aux"] or {}).items():
            np.testing.assert_allclose(got, want, rtol=5e-5, err_msg=k)
        for got, want in zip(*s["net"]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        for got, want in s["lls"]:
            np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", ["nb_table", "nb_crt", "gaussian"])
def test_aux_update_sharded_equals_unsharded(worlds, shape, case):
    """The families' auxiliary updates on a mesh against the unsharded
    update on the same inputs and replicated generator state: NB's r with
    its count table, NB's r from K5's CRT counts of the ranks' tiles
    (gathered and fed to the unsharded update), the Gaussian's eta. The
    counts sum exactly, so the draws are the same; the rates sum over
    time in another fp32 order (rtol 1e-5)."""
    for r in ranks(worlds, shape):
        got, want, lockstep = r["aux"][case]
        assert lockstep
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("fam", ["bernoulli", "negative_binomial"])
def test_indivisible_T_keeps_whole_rows_without_double_count(worlds, shape,
                                                            fam):
    """A dataset whose T the time axis does not divide keeps its whole
    rows, with the JAX package's warning; the sharded log-likelihood (NB:
    with its count table) equals the unsharded one on the same state, the
    sweep warns that it runs the staged loop, and its ll is the model's."""
    for r in ranks(worlds, shape):
        w = r["whole"][fam]
        assert w["whole"] == [False, True]
        assert any("T=257" in m and "whole rows" in m for m in w["warned"])
        assert any("staged" in m for m in w["sweep_warned"])
        assert w["path"] == "mesh_staged"
        np.testing.assert_allclose(w["ll_sharded"], w["ll_unsharded"],
                                   rtol=1e-6)
        np.testing.assert_allclose(w["sweep_ll"], w["ll_after"], rtol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_fit_compiled_equals_fit_on_a_sharded_model(worlds, shape):
    for r in ranks(worlds, shape):
        assert all(r["fit_compiled"].values()), r["fit_compiled"]


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_model_accessors_return_global_values(worlds, shape):
    """On a sharded model A, W, W_effective, bias, copy_sample, generate
    and log_likelihood (of its data and of a new Y) equal the unsharded
    model's from the same state and generators, on every rank; means
    within fp32 rounding; fit_ensemble's sequential path and forecast run
    and agree across ranks."""
    rs = [r["accessors"] for r in ranks(worlds, shape)]
    for r in rs:
        for k in ("A", "W", "W_eff", "bias", "sample", "generate"):
            assert r[k], k
        np.testing.assert_allclose(*r["ll"], rtol=1e-6)
        np.testing.assert_allclose(*r["ll_Y"], rtol=1e-6)
        assert r["means"] <= 1e-5
        assert r["ensemble"]["restored"]
        assert r["ensemble"]["A"].shape == (2, 4, wk.N, wk.N)
        assert np.array_equal(r["ensemble"]["lls"], rs[0]["ensemble"]["lls"])
        assert r["forecast"].shape == (2, 10, wk.N)
        assert np.array_equal(r["forecast"], rs[0]["forecast"])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_checkpoint_resumes_bit_identical(worlds, shape):
    for r in ranks(worlds, shape):
        ck = r["checkpoint"]
        assert ck["a"] == ck["b"] and ck["A_equal"] and ck["W_equal"]


@pytest.mark.parametrize("shape", MESHES)
def test_collectives_ran_on_gloo(worlds, shape):
    for r in ranks(worlds, shape):
        assert r["collectives"]["gloo"] > 0 and r["collectives"]["nccl"] == 0


def test_shard_needs_a_connected_data_mesh():
    import pyglm_tpu_torch as pt
    m = pt.SparseBernoulliGLM(4, B=2, L=4, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError):
            m.shard(S.Mesh(S.DATA_AXES, (1, 1)))
        with pytest.raises(ValueError):
            m.shard(S.Mesh(S.CHAIN_AXES, (1,)))
