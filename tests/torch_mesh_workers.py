"""Rank functions of the port's mesh tests (test_torch_sharding.py,
test_torch_chain_mesh.py, test_torch_chain_data_mesh.py).

They run in ranks started by ``pyglm_tpu_torch.parallel.sharding.spawn``
and import no JAX, so each rank starts quickly; the test files compare
what they return with the JAX package in the parent process. Every input
is made from a seed with numpy, identically on every rank.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

import pyglm_tpu_torch as pt
from pyglm_tpu_torch.models import weights as W
from pyglm_tpu_torch.models.ensemble import lane_inputs, run_stacked_chains
from pyglm_tpu_torch.models.sweep import MeshGenerators
from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.basis import design_matrix, design_matrix_sharded
from pyglm_tpu_torch.parallel import sharding as S
from pyglm_tpu_torch.utils.checkpoint import load_state, save_state

N, B, L, T = 16, 2, 4, 256
G = 4


def spikes(T_=T, N_=N, seed=0, rate=0.2):
    return (np.random.default_rng(seed).random((T_, N_)) < rate).astype(
        np.float32)


def gram_inputs(lanes=N, T_=T, seed=1):
    """(Y, omega) of the Gram tests: a design from spikes, omega > 0."""
    rng = np.random.default_rng(seed)
    Y = spikes(T_, N, seed)
    omega = rng.uniform(0.05, 0.5, (T_, lanes)).astype(np.float32)
    return Y, omega


def _gen_states(model):
    return [g.get_state() for g in model.generators]


def _model(kind, seed=3, **kw):
    """One model per configuration of the sweep tests."""
    fam, net, ss = kind
    kw = dict(B=B, L=L, seed=seed, device="cpu", observation=fam,
              network=net, spike_and_slab=ss, **kw)
    if fam == "negative_binomial":
        kw["obs_kwargs"] = dict(max_y=64)
        kw["net_kwargs"] = dict(sigma_w=0.003, mu_bias=-2.0)
    elif fam == "gaussian":
        kw["net_kwargs"] = dict(sigma_w=0.05, mu_bias=0.0)
    if net == "sbm":
        kw["net_kwargs"] = {**kw.get("net_kwargs", {}), "K": 2}
    return pt.NonlinearAutoregressiveModel(N, **kw)


SWEEP_KINDS = [
    ("bernoulli", "erdos_renyi", True), ("binomial", "erdos_renyi", True),
    ("negative_binomial", "erdos_renyi", True),
    ("gaussian", "erdos_renyi", True),
    ("bernoulli", "dense", False), ("bernoulli", "sbm", True),
    ("bernoulli", "latent_distance", True),
    ("gaussian", "dense", False), ("negative_binomial", "dense", False),
]


def _update_case(mesh, path, precision="high", dense=False, device="cpu",
                 N=N, T=T, G=G):
    """The spike-and-slab (both loops) or dense update on `mesh` against
    the unsharded update, on the same omega, kappa and noise."""
    rng = np.random.default_rng(7)
    m = pt.SparseBernoulliGLM(N, B=B, L=L, seed=5, device=device)
    Y = torch.from_numpy(spikes(T, N))
    m.add_data(Y)
    d = m.datas[0]
    st = m.state
    w = W.pack_weights(st.A, st.W, st.b)
    hyp = m.network.edge_hypers(st.net, device)
    psi = d.Xf @ w
    omega = torch.from_numpy(rng.uniform(0.05, 0.3, (T, N)).astype(
        np.float32)).to(device)
    kappa = d.Y - 0.5
    lay = S.glm_shardings(mesh, T, N)
    r, ln = lay.rows, lay.lanes
    hyp_l = W.lane_hypers(hyp, ln)
    if dense:
        J, h = W.sufficient_stats(d.Xf, omega, kappa)
        eps = torch.from_numpy(rng.standard_normal((N, N * B + 1)).astype(
            np.float32)).to(device)
        w_u = W.resample_dense(None, J, h, hyp, B, eps=eps)
        J_l, h_l = W.sufficient_stats(d.Xf[r], omega[r, ln].contiguous(),
                                      kappa[r, ln].contiguous(), mesh=mesh)
        w_s = W.resample_dense(None, J_l, h_l, hyp_l, B,
                               eps=eps[ln].contiguous())
        return {"w_u": w_u[:, ln], "w_s": w_s, "A_u": None, "A_s": None}
    ng = N // G
    noise = W.SpikeSlabNoise(*(torch.from_numpy(x.astype(np.float32)).to(
        device) for x in (rng.random((ng, G, N)),
                          rng.standard_normal((ng, G, N, B)),
                          rng.standard_normal(N))))
    A_u, w_u, u_u, _ = W.resample_spike_slab_tspace(
        None, d.Xt, omega, kappa, psi, w, hyp, B, group=G, noise=noise,
        path=path, precision=precision)
    # the unsharded update on the rank's lanes alone: the same work as a
    # mesh without a time split, in the same order
    A_b, w_b, u_b, _ = W.resample_spike_slab_tspace(
        None, d.Xt, omega[:, ln].contiguous(), kappa[:, ln].contiguous(),
        psi[:, ln].contiguous(), w[:, ln], hyp_l, B, group=G,
        noise=W.SpikeSlabNoise(noise.u_a[..., ln], noise.eps[:, :, ln],
                               noise.bias[ln]),
        path=path, precision=precision)
    before = dict(_build.LAUNCHES)
    A_s, w_s, u_s, _ = W.resample_spike_slab_tspace(
        None, d.Xt[:, r].contiguous(), omega[r, ln].contiguous(),
        kappa[r, ln].contiguous(), psi[r, ln].contiguous(), w[:, ln],
        hyp_l, B, group=G, noise=noise, path="mesh_" + path,
        precision=precision, mesh=mesh)
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    return {"A_u": A_u[:, ln], "A_s": A_s, "w_u": w_u[:, ln], "w_s": w_s,
            "u_u": u_u[r, ln], "u_s": u_s, "path": W.LAST_SS_PATH,
            "block_equal": all(torch.equal(a, b) for a, b in (
                (A_s, A_b), (w_s, w_b), (u_s, u_b[r]))),
            "launches": launches}


def _sweeps(mesh):
    """3 sharded sweeps of every configuration: finite diagnostics, the
    replicated generators' states after them, the shard generators'."""
    out = {}
    for kind in SWEEP_KINDS:
        m = _model(kind)
        m.add_data(_data(m, kind[0]))
        m.shard(mesh)
        diags = [m.resample_model() for _ in range(3)]
        out[kind] = {
            "lls": [d_["log_likelihood"] for d_ in diags],
            "n_edges": [d_["n_edges"] for d_ in diags],
            "A": m.A, "bias": m.bias, "gens": _gen_states(m),
            "path": W.LAST_SS_PATH}
    return out


@contextlib.contextmanager
def _pg_means():
    """The families' PG draws replaced by their means E[PG(b, psi)]: omega
    is then a function of psi, and a sweep's only random numbers are the
    replicated ones (the update's noise, the bias normals, the aux and
    network draws), which a sharded and an unsharded sweep draw alike."""
    from pyglm_tpu_torch.models import observations as O
    saved = O.pg_draw_unit, O.polya_gamma
    O.pg_draw_unit = lambda c, generator, mesh=None: pt.pg_mean(1.0, c)
    O.polya_gamma = lambda b, c, generator, method="auto": pt.pg_mean(b, c)
    try:
        yield
    finally:
        O.pg_draw_unit, O.polya_gamma = saved


def _sweeps_vs_unsharded(mesh, n_sweeps=2):
    """`n_sweeps` sharded sweeps of every configuration against the same
    model's unsharded sweeps, from the same state and generators, on
    omega = E[PG(b, psi)]: the whole states and lls of both."""
    out = {}
    with _pg_means():
        for kind in SWEEP_KINDS:
            m, u = _model(kind), _model(kind)
            Y = _data(m, kind[0])
            _data(u, kind[0])           # the same draws, in lockstep
            m.add_data(Y)
            u.add_data(Y)
            m.shard(mesh)
            lls = [(m.resample_model()["log_likelihood"],
                    u.resample_model()["log_likelihood"])
                   for _ in range(n_sweeps)]
            full = m._full_state()
            out[kind] = {
                "lls": lls, "A": (m.A, u.A), "W": (m.W, u.W),
                "bias": (m.bias, u.bias),
                "aux": (None if full.aux is None else
                        {k: (v.numpy(), u.state.aux[k].numpy())
                         for k, v in full.aux.items()}),
                "net": (m.copy_sample()["net"], u.copy_sample()["net"]),
                "gens": all(torch.equal(a.get_state(), b.get_state())
                            for a, b in zip(m.generators, u.generators))}
    return out


def _aux_case(mesh, n_lanes=N, T_=T):
    """A family's auxiliary update on `mesh` against the unsharded update
    on the same Y, psi and aux, with the replicated generator in the same
    state: NB's r with its count table (the table summed over "time"),
    NB's r without it (K5's CRT sums of each rank's tile, drawn again
    from the shard generator's state, summed over "time" and gathered,
    fed to the unsharded update in place of its own draw) and the
    Gaussian's eta. Returns {case: (sharded at the rank's lanes, unsharded
    there, the replicated generators equal after)}."""
    from pyglm_tpu_torch.models import observations as O
    rng = np.random.default_rng(41)
    Y = torch.from_numpy(rng.poisson(3.0, (T_, n_lanes)).astype(np.float32))
    psi = torch.from_numpy(rng.normal(0.5, 1.0, (T_, n_lanes)).astype(
        np.float32))
    aux = torch.from_numpy(rng.uniform(1.0, 6.0, n_lanes).astype(np.float32))
    lay = S.glm_shardings(mesh, T_, n_lanes)
    rows, ln = lay.rows, lay.lanes
    Yl, psil = Y[rows, ln].contiguous(), psi[rows, ln].contiguous()
    nb = O.NegativeBinomial(max_y=64)
    table = S.all_reduce_sum(nb.ll_cache(Y[rows])["counts"][:, ln]
                             .contiguous(), mesh, "time")
    out = {}
    for case, fam, key, cache in (
            ("nb_table", nb, "r", {"counts": table}),
            ("nb_crt", nb, "r", None),
            ("gaussian", O.Gaussian(), "eta", None)):
        rep = torch.Generator().manual_seed(43)
        twin = torch.Generator().manual_seed(43)
        shard_gen = torch.Generator().manual_seed(44 + S.shard_index(mesh))
        crt_state = shard_gen.get_state()
        got = fam.resample_aux(shard_gen, {key: aux[ln]}, Yl, psil,
                               cache=cache,
                               shard=S.lane_shard(mesh, n_lanes, rep))[key]
        saved = O.crt_sample_sums
        if case == "nb_crt":
            s_full = S.time_sum_lanes(O.crt_sample_sums(
                Yl, aux[ln], nb.max_y,
                torch.Generator().set_state(crt_state)), mesh)
            O.crt_sample_sums = lambda Y_, r_, max_y, g_: s_full
        try:
            want = fam.resample_aux(
                twin, {key: aux}, Y, psi,
                cache=None if cache is None else nb.ll_cache(Y))[key]
        finally:
            O.crt_sample_sums = saved
        out[case] = (got, want[ln], torch.equal(rep.get_state(),
                                                twin.get_state()))
    return out


def _data(m, fam, T_=T):
    """Data for a model of family `fam`: its own simulation (counts capped
    at max_y), or standard normals for the Gaussian, whose dense
    autoregression at these widths diverges."""
    if fam == "gaussian":
        return np.random.default_rng(T_).standard_normal((T_, N)).astype(
            np.float32)
    Y = m.generate(T_, keep=False)
    return np.minimum(Y, 64) if fam == "negative_binomial" else Y


def _sharded_vs_unsharded_ll(mesh):
    """A dataset the time axis divides and one it does not: the warning,
    and the sharded log-likelihood equal to the unsharded one on the same
    state (no double count of the whole rows)."""
    out = {}
    for fam in ("bernoulli", "negative_binomial"):
        m = _model((fam, "erdos_renyi", True), seed=9)
        u = _model((fam, "erdos_renyi", True), seed=9)
        for Tn in (T, T + 1):
            Y = spikes(Tn, seed=Tn)
            m.add_data(Y)
            u.add_data(Y)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            m.shard(mesh)
        out[fam] = {"warned": [str(w_.message) for w_ in rec],
                    "ll_sharded": m.log_likelihood(),
                    "ll_unsharded": u.log_likelihood(),
                    "whole": [d.whole for d in m.datas]}
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            diag = m.resample_model()
        out[fam]["sweep_warned"] = [str(w_.message) for w_ in rec]
        out[fam]["sweep_ll"] = diag["log_likelihood"]
        # the sweep's ll is the model's total on the new state
        out[fam]["ll_after"] = m.log_likelihood()
        out[fam]["path"] = W.LAST_SS_PATH
    return out


def _checkpoint(mesh, path):
    m = _model(("negative_binomial", "erdos_renyi", True), seed=11)
    m.add_data(np.minimum(m.generate(T, keep=False), 64))
    m.shard(mesh)
    m.resample_model()
    save_state(path, m)
    a = [m.resample_model()["log_likelihood"] for _ in range(3)]
    A_a, W_a = m.A, m.W
    load_state(path, m)
    b = [m.resample_model()["log_likelihood"] for _ in range(3)]
    return {"a": a, "b": b, "A_equal": bool(np.array_equal(A_a, m.A)),
            "W_equal": bool(np.array_equal(W_a, m.W))}


def _accessors(mesh):
    """A sharded model's public accessors against the same model
    unsharded, from the same state and generators."""
    m = _model(("bernoulli", "erdos_renyi", True), seed=15)
    u = _model(("bernoulli", "erdos_renyi", True), seed=15)
    Y = m.generate(T, keep=False)
    u.generate(T, keep=False)
    m.add_data(Y)
    u.add_data(Y)
    m.shard(mesh)
    out = {"A": np.array_equal(m.A, u.A), "W": np.array_equal(m.W, u.W),
           "W_eff": np.array_equal(m.W_effective, u.W_effective),
           "bias": np.array_equal(m.bias, u.bias),
           "sample": all(np.array_equal(a, b) for a, b in zip(
               m.copy_sample()["net"], u.copy_sample()["net"])),
           "ll": (m.log_likelihood(), u.log_likelihood()),
           "ll_Y": (m.log_likelihood(Y[:100]), u.log_likelihood(Y[:100])),
           "means": float(np.abs(m.means[0] - u.means[0]).max()),
           "generate": np.array_equal(m.generate(40, keep=False),
                                      u.generate(40, keep=False))}
    st0 = m.state
    ens = m.fit_ensemble(n_chains=2, n_samples=4, stacked=False)
    out["ensemble"] = {"restored": m.state is st0, "A": ens["A"],
                       "lls": ens["lls"]}
    out["forecast"] = m.forecast(10, n_samples=2)
    return out


def _fit_compiled(mesh):
    m = _model(("bernoulli", "erdos_renyi", True), seed=13)
    m.add_data(m.generate(T, keep=False))
    m.shard(mesh)
    s0 = [g.get_state() for g in (*m.generators, *m.shard_generators)]
    st0 = m.state
    fc = m.fit_compiled(n_samples=3, n_burnin=1, max_sweeps_per_launch=2)
    m.state = st0
    for g, s in zip((*m.generators, *m.shard_generators), s0):
        g.set_state(s)
    f = m.fit(n_samples=3, n_burnin=1)
    return {k: bool(np.array_equal(fc[k], f[k])) for k in fc}


def sharding_rank(rank, world, tmpdir):
    """All of test_torch_sharding.py's work on one world."""
    res = {"rank": rank}
    meshes = {(2, 1): None, (1, 2): None} if world == 2 else \
        {(2, 2): None, (4, 1): None}
    for shape in meshes:
        mesh = pt.make_mesh(*shape)
        r = {"coords": mesh.coords, "lanes": S.lane_slice(mesh, N),
             "rows": S.glm_shardings(mesh, T, N).rows}
        Y = torch.from_numpy(spikes())
        lay = S.glm_shardings(mesh, T, N, L=L)
        basis = pt.cosine_basis(B=B, L=L)
        r["design"] = design_matrix_sharded(Y[lay.rows], basis, mesh)
        r["design_err"] = _design_errors(mesh)
        Yg, om = gram_inputs()
        Xf = design_matrix(torch.from_numpy(Yg), basis)
        Xt = Xf.T.contiguous()
        omt = torch.from_numpy(om)
        r["gram"] = W.group_gram_blocks(Xt[:, lay.rows].contiguous(),
                                        omt[lay.rows, lay.lanes].contiguous(),
                                        B, G, precision="high", mesh=mesh)
        r["stats"] = W.sufficient_stats(
            Xf[lay.rows], omt[lay.rows, lay.lanes].contiguous(),
            omt[lay.rows, lay.lanes].contiguous(), mesh=mesh)
        r["update"] = {(p, prec): _update_case(mesh, p, prec)
                       for p, prec in (("fused", "high"),
                                       ("staged", "high"),
                                       ("fused", "default"),
                                       ("staged", "highest"))}
        r["update_dense"] = _update_case(mesh, None, dense=True)
        r["pg"] = _pg_draws(mesh)
        r["sweeps"] = _sweeps(mesh)
        r["sweeps_vs_unsharded"] = _sweeps_vs_unsharded(mesh)
        r["aux"] = _aux_case(mesh)
        r["fit_compiled"] = _fit_compiled(mesh)
        r["accessors"] = _accessors(mesh)
        if shape[0] > 1:
            r["whole"] = _sharded_vs_unsharded_ll(mesh)
        r["checkpoint"] = _checkpoint(
            mesh, f"{tmpdir}/ck_{shape[0]}x{shape[1]}.npz")
        r["collectives"] = dict(mesh.collectives)
        res[shape] = r
    return res


def _design_errors(mesh):
    """The messages design_matrix_sharded raises on unequal or short time
    blocks."""
    basis = pt.cosine_basis(B=B, L=L)
    out = []
    t = mesh.index("time")
    for rows in ((T // 2 + t, N), (L - 1, N)):
        if mesh.shape["time"] == 1 and rows[0] != L - 1:
            continue
        try:
            design_matrix_sharded(torch.zeros(rows), basis, mesh)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _pg_draws(mesh):
    """pg_draw_unit / polya_gamma on a mesh: the gathered tiles, and each
    rank's own tile drawn on the same shard generator without a mesh."""
    rng = np.random.default_rng(21)
    c = torch.from_numpy(rng.normal(0, 2, (T, N)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.5, 3, (T, N)).astype(np.float32))
    g1 = S.shard_generators(0, mesh).host
    g2 = S.shard_generators(0, mesh).host
    whole = pt.pg_draw_unit(c, g1, mesh=mesh)
    tile = pt.pg_draw_unit(S.local_tile(c, mesh), g2)
    whole_b = pt.polya_gamma(b, c, g1, mesh=mesh)
    tile_b = pt.polya_gamma(S.local_tile(b, mesh), S.local_tile(c, mesh), g2)
    lay = S.glm_shardings(mesh, T, N)
    return {"whole": whole, "tile_ok": bool(torch.equal(
        whole[lay.rows, lay.lanes], tile)),
        "tile_b_ok": bool(torch.equal(whole_b[lay.rows, lay.lanes],
                                      tile_b))}


# ---------------------------------------------------------------------------
# Chain meshes
# ---------------------------------------------------------------------------

def _ens_model(seed=2, **kw):
    m = pt.NonlinearAutoregressiveModel(
        8, B=B, L=L, seed=seed, device="cpu", spike_and_slab=True,
        network="latent_distance", **kw)
    m.add_data(m.generate(200, keep=False))
    return m


def chain_rank(rank, world, mesh_kind):
    """test_torch_chain_mesh.py (mesh_kind "chain": a ("chain",) mesh of
    the world) and test_torch_chain_data_mesh.py ("chain_data": 2 x 2 x 1
    of four ranks) on one world."""
    from pyglm_tpu_torch.models import tempering as TP
    if mesh_kind == "chain":
        mesh = pt.make_chain_mesh()
    else:
        mesh = pt.make_chain_data_mesh(2, n_time=2)
    m = _ens_model()
    C = 4
    res = {"rank": rank, "coords": mesh.coords}
    # initial states: no sweep
    init = run_stacked_chains(m, C, 0, mesh=mesh, collect="mean")
    base = run_stacked_chains(m, C, 0, collect="mean")
    res["init_equal"] = all(
        torch.equal(getattr(a, f), getattr(b_, f))
        for a, b_ in zip(init["final_states"], base["final_states"])
        for f in ("A", "W", "b"))
    mean = m.fit_ensemble(n_chains=C, n_samples=4, n_burnin=1, mesh=mesh,
                          collect="mean")
    samp = m.fit_ensemble(n_chains=C, n_samples=4, n_burnin=1, mesh=mesh)
    res["mean"] = {k: mean[k] for k in ("A_mean", "Weff_mean", "lls",
                                        "rhat_ll")}
    res["samples"] = {k: samp[k] for k in ("A", "W", "lls", "rhat_ll")}
    # the tempered sweep on the mesh against its parts
    betas = np.asarray([0.25, 0.5, 0.75, 1.0])
    mt = _ens_model(seed=4)
    res["tempered"] = _tempered_swap(mt, betas, mesh, TP)
    fit = mt.fit_tempered(n_samples=4, betas=betas, mesh=mesh)
    res["fit_tempered"] = {k: fit[k] for k in ("A", "lls", "swap_rate")}
    res["errors"] = _mesh_errors(m, mesh)
    if mesh_kind == "chain_data":
        res["update"] = _stacked_update_case(mesh)
        # NB's r update without a count table (the stacked sweep reads
        # none): the CRT counts of the rank's tile, summed over "time"
        nb = _model(("negative_binomial", "erdos_renyi", True), seed=17)
        nb.add_data(_data(nb, "negative_binomial", 200))
        out = nb.fit_ensemble(n_chains=C, n_samples=4, mesh=mesh,
                              collect="mean")
        res["aux"] = _aux_case(mesh, n_lanes=C * 16, T_=200)
        res["nb"] = {"lls": out["lls"],
                     "r": np.stack([s.aux["r"].numpy()
                                    for s in out["final_states"]])}
    return res


def _tempered_swap(m, betas, mesh, TP):
    """One tempered sweep on `mesh` against the pass run apart and
    permute_states of the gathered stack by swap_permutation's perm on the
    same parity bit and uniforms."""
    from pyglm_tpu_torch.models.glm import _copy_generators
    kw = dict(spike_slab=True, group=m.group, precision=m.precision)
    C = len(betas)
    gens = TP.tempered_mesh_generators(list(range(1, C + 1)), mesh, "cpu")
    twin = MeshGenerators(_copy_generators(gens.replicated),
                          _copy_generators(gens.shard))
    datas = tuple(m.datas)
    if "time" in mesh.shape:
        from pyglm_tpu_torch.models.ensemble import (
            chain_data_shardings, make_stacked_sweep_gspmd)
        datas = chain_data_shardings(mesh, None, datas)[1]
        sweep = TP.make_tempered_sweep_gspmd(m.observation, m.network, m.N,
                                             m.B, betas, mesh, **kw)
        gibbs = make_stacked_sweep_gspmd(
            m.observation, m.network, m.N, m.B, C, mesh, True,
            group=m.group, precision=m.precision, betas=betas)
        st0 = TP.init_tempered_states(m, betas)
        passed, d = gibbs(twin, st0, datas)
        lls = d["log_likelihood"]
    else:
        from pyglm_tpu_torch.models.ensemble import (
            make_stacked_sweep_sharded)
        Cl = C // mesh.shape["chain"]
        rungs = slice(mesh.index("chain") * Cl,
                      (mesh.index("chain") + 1) * Cl)
        sweep = TP.make_tempered_sweep_sharded(m.observation, m.network,
                                               m.N, m.B, betas, mesh, **kw)
        gibbs = make_stacked_sweep_sharded(
            m.observation, m.network, m.N, m.B, C, mesh, True,
            group=m.group, precision=m.precision, betas=betas)
        st0 = TP.init_tempered_states(m, betas, rungs=rungs)
        passed, d = gibbs(twin.shard, st0, datas)
        passed = S.gather_tree(passed, mesh, "chain")
        lls = S.all_gather(d["log_likelihood"], mesh, "chain")
    parity = int(torch.randint(0, 2, (), generator=twin.replicated.host))
    uniforms = torch.rand((C,), generator=twin.replicated.host)
    perm, _, _ = TP.swap_permutation(None, lls, betas, parity=parity,
                                     uniforms=uniforms)
    want = TP.permute_states(passed, perm)
    st, diag = sweep(gens, st0, datas)
    full = diag.get("full_state", st)
    return {"equal": all(torch.equal(getattr(full, f), getattr(want, f))
                         for f in ("A", "W", "b")),
            "parity": (diag["swap_parity"], parity),
            "local_is_slice": bool("full_state" not in diag or torch.equal(
                st.A, full.A[mesh.index("chain") * (C // mesh.shape["chain"]):
                             (mesh.index("chain") + 1)
                             * (C // mesh.shape["chain"])])),
            "rep_state": [g.get_state() for g in gens.replicated]}


def _mesh_errors(m, mesh):
    """The ValueErrors of the mesh rules."""
    out = {}
    for name, call in (
            ("not_a_mesh", lambda: m.fit_ensemble(4, 4, mesh=object())),
            ("no_chain_axis", lambda: m.fit_ensemble(
                4, 4, mesh=S.Mesh(S.DATA_AXES, (1, 1)))),
            ("unstacked", lambda: m.fit_ensemble(4, 4, stacked=False,
                                                 mesh=mesh)),
            ("tempered_not_a_mesh", lambda: m.fit_tempered(
                4, betas=np.asarray([0.5, 1.0]), mesh=object())),
            ("indivisible", lambda: m.fit_ensemble(3, 4, mesh=mesh))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _stacked_update_case(mesh):
    """The spike-and-slab update of 4 stacked chains on a chain-data mesh
    against the unsharded stacked update, on the same omega and noise."""
    rng = np.random.default_rng(31)
    m = _ens_model(seed=6)
    C = 4
    from pyglm_tpu_torch.models.ensemble import (
        ensemble_generators, stack_states, unstack_states)
    from pyglm_tpu_torch.models.sweep import init_state_from_prior
    st = stack_states([init_state_from_prior(
        ensemble_generators(s, "cpu"), m.observation, m.network, m.N, m.B,
        True, "cpu") for s in range(1, C + 1)])
    w, hyp = lane_inputs(m.network, unstack_states(st, C))
    d = m.datas[0]
    Tn, CN = d.Y.shape[0], C * m.N
    psi = d.Xf @ w
    omega = torch.from_numpy(rng.uniform(0.05, 0.3, (Tn, CN)).astype(
        np.float32))
    kappa = d.Y.repeat(1, C) - 0.5
    Gm = m.group
    ng = m.N // Gm
    noise = W.SpikeSlabNoise(
        torch.from_numpy(rng.random((ng, Gm, CN)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((ng, Gm, CN, B)).astype(
            np.float32)),
        torch.from_numpy(rng.standard_normal(CN).astype(np.float32)))
    A_u, w_u, _, _ = W.resample_spike_slab_tspace(
        None, d.Xt, omega, kappa, psi, w, hyp, B, group=Gm, noise=noise,
        path="fused", precision="high")
    lay = S.glm_shardings(mesh, Tn, CN)
    r, ln = lay.rows, lay.lanes
    hyp_l = W.lane_hypers(hyp, ln)
    A_s, w_s, _, _ = W.resample_spike_slab_tspace(
        None, d.Xt[:, r].contiguous(), omega[r, ln].contiguous(),
        kappa[r, ln].contiguous(), psi[r, ln].contiguous(), w[:, ln], hyp_l,
        B, group=Gm, noise=noise, precision="high", mesh=mesh)
    return {"A_u": A_u[:, ln], "A_s": A_s, "w_u": w_u[:, ln], "w_s": w_s,
            "path": W.LAST_SS_PATH}


# ---------------------------------------------------------------------------
# On the card (tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

def cuda_update_rank(rank, world):
    """The update on cuda:0 at N=20, T=3000 (G=10) on meshes (2, 1) and
    (1, 2) of this world of 2 gloo ranks, against the unsharded update on
    the card (and on the rank's lanes alone); the launch counts of the
    sharded calls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = pt.make_mesh(*shape)
        for path in ("fused", "staged"):
            r = _update_case(mesh, path, device="cuda", N=20, T=3000, G=10)
            out[shape, path] = {
                "A_equal": bool(torch.equal(r["A_s"], r["A_u"])),
                "w_err": float((r["w_s"] - r["w_u"]).abs().max()),
                "block_equal": r["block_equal"],
                "path": r["path"], "launches": r["launches"]}
    return out


def cuda_nccl_rank(rank, world):
    """A small sharded model on a one-rank NCCL mesh: 2 sweeps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pt.make_mesh(1, 1)
    m = pt.SparseBernoulliGLM(20, B=B, L=L, seed=5, device="cuda")
    m.add_data(spikes(3000, 20))
    m.shard(mesh)
    lls = [m.resample_model()["log_likelihood"] for _ in range(2)]
    return {"backend": mesh.backend, "collectives": dict(mesh.collectives),
            "lls": lls, "path": W.LAST_SS_PATH}
