"""K7 (csrc/ld_hmc.cu, ops/ld_hmc_cuda.py), the latent-distance HMC move in
one launch, on the CPU:

- the layout plan: the cluster and rows at the model's shapes, every CTA
  owning rows, the shared memory within a block's, the constants against
  the kernel's source;
- the wrapper refuses bad shapes, dtypes, layouts and devices before it
  loads the library or launches anything;
- CPU tensors take the plain move (no K7 launch), and every model path
  (single chain, stacked, tempered) hands the move tensors K7 takes;
- the pair formulas K7 sums (over S = A + A^T) equal the plain potential
  and gradient in float64;
- the plain move's log ratios are its tests.
"""
import re
from pathlib import Path

import pytest
import torch

import pyglm_tpu_torch as pt
from pyglm_tpu_torch.models.ensemble import (
    chain_generators, ensemble_generators, make_stacked_sweep, stack_states)
from pyglm_tpu_torch.models.networks import (
    LatentDistanceConfig, LatentDistanceState)
from pyglm_tpu_torch.models.sweep import Generators, init_state_from_prior
from pyglm_tpu_torch.models.tempering import make_tempered_sweep
from pyglm_tpu_torch.ops import _build, ld_hmc_cuda as k7
from pyglm_tpu_torch.utils.utils import softplus

torch.set_num_threads(1)
SRC = Path(k7.__file__).resolve().parents[1] / "csrc" / "ld_hmc.cu"


@pytest.mark.parametrize("N,dim,cluster,rows,pos,slab", [
    (500, 2, 8, 63, True, True),       # config 5
    (37, 2, 1, 37, True, True),
    (64, 1, 1, 64, True, True),
    (65, 3, 2, 33, True, True),
    (333, 2, 8, 42, True, True),
    (2000, 2, 8, 250, True, False),
    (4000, 8, 8, 500, False, False),
])
def test_plan_at_the_model_shapes(N, dim, cluster, rows, pos, slab):
    plan = k7.ld_hmc_plan(N, dim)
    assert (plan["cluster"], plan["rows"], plan["pos_in_smem"],
            plan["slab_in_smem"]) == (cluster, rows, pos, slab)


@pytest.mark.parametrize("dim", range(1, 9))
def test_plan_every_cta_owns_rows_and_fits(dim):
    for N in list(range(1, 300)) + list(range(300, 4097, 37)) + [4096]:
        p = k7.ld_hmc_plan(N, dim)
        K, R = p["cluster"], p["rows"]
        assert K & (K - 1) == 0 and 1 <= K <= k7.MAX_CLUSTER
        assert K * R >= N > (K - 1) * R and R <= k7.MAX_ROWS
        want = (k7._HEAD_BYTES + k7._align16(20 * R * dim)
                + p["pos_in_smem"] * 2 * k7._align16(4 * N * dim)
                + p["slab_in_smem"] * k7._align16(R * N))
        assert p["smem"] == want <= k7.SMEM_BYTES


@pytest.mark.parametrize("N,dim", [(4097, 2), (0, 2), (500, 0), (500, 9)])
def test_plan_refuses_what_k7_does_not_take(N, dim):
    with pytest.raises(ValueError):
        k7.ld_hmc_plan(N, dim)


def test_plan_constants_match_the_kernel():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kThreads") == k7.THREADS
    assert const("kMaxCluster") == k7.MAX_CLUSTER
    assert "kRedBytes = 2 * kMaxCluster * 2 * 8" in src
    assert "kWarpBytes = kWarps * 2 * 8" in src
    assert "align16(5LL * rows * dim * 4)" in src
    assert "2 * align16((long long)N * dim * 4)" in src
    assert "align16((long long)rows * N)" in src
    assert "PGT_CASE(8)" in src and k7.MAX_DIM == 8


def _args(C=2, N=10, dim=2, k=3):
    g = torch.Generator().manual_seed(0)
    return dict(L=torch.randn(C, N, dim, generator=g), gamma=torch.zeros(C),
                A=(torch.rand(C, N, N, generator=g) < 0.3).float(),
                mom_L=torch.randn(C, k, N, dim, generator=g),
                mom_gamma=torch.randn(C, k, generator=g),
                u_hmc=torch.rand(C, k, generator=g))


BAD = {
    "L_rank": (dict(L=torch.zeros(10, 2)), ValueError, "shape"),
    "gamma_shape": (dict(gamma=torch.zeros(3)), ValueError, "gamma"),
    "A_shape": (dict(A=torch.zeros(2, 10, 9)), ValueError, "A must"),
    "mom_L_shape": (dict(mom_L=torch.zeros(2, 3, 10, 3)), ValueError,
                    "mom_L"),
    "mom_gamma_shape": (dict(mom_gamma=torch.zeros(2, 4)), ValueError,
                        "mom_gamma"),
    "u_shape": (dict(u_hmc=torch.zeros(2)), ValueError, "u_hmc"),
    "float64": (dict(A=torch.zeros(2, 10, 10, dtype=torch.float64)),
                TypeError, "float32"),
    "not_contiguous": (dict(A=torch.zeros(2, 10, 10).transpose(1, 2)),
                       ValueError, "contiguous"),
    "dim_9": (dict(L=torch.zeros(2, 10, 9),
                   mom_L=torch.zeros(2, 3, 10, 9)), ValueError, "dim"),
    "N_4097": (dict(L=torch.zeros(1, 4097, 1), gamma=torch.zeros(1),
                    mom_L=torch.zeros(1, 3, 4097, 1),
                    mom_gamma=torch.zeros(1, 3), u_hmc=torch.zeros(1, 3)),
               ValueError, "N <="),
    "no_chains": (dict(L=torch.zeros(0, 10, 2), gamma=torch.zeros(0),
                       A=torch.zeros(0, 10, 10),
                       mom_L=torch.zeros(0, 3, 10, 2),
                       mom_gamma=torch.zeros(0, 3), u_hmc=torch.zeros(0, 3)),
                  ValueError, "chains"),
    "steps_0": ({}, ValueError, "hmc_steps"),
    "cpu": ({}, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses_bad_input_before_any_launch(monkeypatch, case):
    def no_library():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_build, "library", no_library)
    change, err, match = BAD[case]
    args = {**_args(), **change}
    if case == "N_4097":           # A of the right shape, left unfilled
        args["A"] = torch.empty(1, 4097, 4097)
    before = dict(_build.LAUNCHES)
    with pytest.raises(err, match=match):
        k7.ld_hmc_cuda(**args, eps=0.01, steps=0 if case == "steps_0" else 5,
                       sigma_l=1.0, sigma_gamma=2.0)
    assert _build.LAUNCHES == before


def _ld_problem(C=2, N=12, seed=0, **kw):
    cfg = LatentDistanceConfig(N=N, B=2, hmc_eps=0.05, hmc_steps=6,
                               hmc_iters=4, **kw)
    g = torch.Generator().manual_seed(seed)
    L = torch.randn(C, N, cfg.dim, generator=g)
    gamma = torch.linspace(-0.5, 0.5, C)
    A = (torch.rand(C, N, N, generator=g)
         < torch.sigmoid(cfg._logit_rho(L, gamma))).float()
    return cfg, L, gamma, A, cfg.draw_noise(g, C, "cpu")


def test_cpu_tensors_take_the_plain_move():
    cfg, L, gamma, A, noise = _ld_problem()
    before = _build.LAUNCHES["ld_hmc"]
    out = cfg._hmc(L, gamma, A, noise)
    plain = cfg._hmc_plain(L, gamma, A, noise)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    st = LatentDistanceState(L, gamma, torch.zeros(2, 2),
                             torch.eye(2).repeat(2, 1, 1), torch.zeros(2))
    gens = Generators(torch.Generator().manual_seed(1),
                      torch.Generator().manual_seed(2))
    W = torch.randn(*A.shape, 2) * A[..., None]
    res = cfg.resample(gens, st, A, W)
    assert res.L.shape == L.shape
    assert _build.LAUNCHES["ld_hmc"] == before


def test_log_ratios_are_the_moves_tests():
    cfg, L, gamma, A, noise = _ld_problem(C=3, seed=4)
    ratios = []
    out = cfg._hmc_plain(L, gamma, A, noise, log_ratios=ratios)
    assert len(ratios) == cfg.hmc_iters and ratios[0].shape == (3,)
    acc = torch.log(noise.u_hmc) < torch.stack(ratios, dim=1)
    assert torch.equal(out[2], acc.sum(1).float() / cfg.hmc_iters)
    assert all(torch.equal(a, b) for a, b in
               zip(out, cfg._hmc_plain(L, gamma, A, noise)))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_k7_pair_formulas_equal_the_plain_potential(dim):
    """U, dU/dL and dU/dgamma as K7 sums them, over ordered pairs with
    S = A + A^T (0, 1 or 2): per row k, dU/dl_k = 2 sum_j (2 sigmoid - S)
    (l_j - l_k) + l_k / sigma_l^2, dU/dgamma = sum (sigmoid - S / 2) +
    gamma / sigma_gamma^2, U = sum_k (|l_k|^2 / (2 sigma_l^2) - sum_j
    (S / 2 lrho - softplus(lrho))) + gamma^2 / (2 sigma_gamma^2); float64."""
    cfg, L, gamma, A, _ = _ld_problem(C=3, N=40, seed=dim, dim=dim,
                                      sigma_l=1.3, sigma_gamma=1.7)
    L, gamma, A = L.double(), gamma.double(), A.double()
    S = A + A.transpose(1, 2)
    dx = L[:, None, :, :] - L[:, :, None, :]          # [c, k, j] = l_j - l_k
    lr = gamma[:, None, None] - (dx ** 2).sum(-1)
    sg = torch.sigmoid(lr)
    gL = (2 * ((2 * sg - S)[..., None] * dx).sum(2)
          + L / cfg.sigma_l ** 2)
    gg = (sg - S / 2).sum((1, 2)) + gamma / cfg.sigma_gamma ** 2
    U = ((L ** 2).sum((1, 2)) / (2 * cfg.sigma_l ** 2)
         - (S / 2 * lr - softplus(lr)).sum((1, 2))
         + gamma ** 2 / (2 * cfg.sigma_gamma ** 2))
    pL, pg = cfg._potential_grad(L, gamma, A)
    torch.testing.assert_close(gL, pL, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gg, pg, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(U, cfg._potential(L, gamma, A), rtol=1e-12,
                               atol=1e-10)


def _model(seed=0):
    m = pt.NonlinearAutoregressiveModel(
        6, B=2, L=4, seed=seed, network="latent_distance",
        spike_and_slab=True, device="cpu",
        net_kwargs=dict(hmc_steps=3, hmc_iters=2))
    m.generate(300, keep=True)
    return m


def _lanes(m, tempered):
    N, B, C = 6, 2, 2
    if tempered:
        sweep = make_tempered_sweep(m.observation, m.network, N, B,
                                    [0.5, 1.0], group=m.group,
                                    precision=m.precision)
    else:
        sweep = make_stacked_sweep(m.observation, m.network, N, B, C, True,
                                   group=m.group, precision=m.precision)
    st = stack_states([init_state_from_prior(
        ensemble_generators(sd, "cpu"), m.observation, m.network, N, B,
        True, "cpu") for sd in range(1, C + 1)])
    return lambda: sweep(chain_generators(99, "cpu"), st, tuple(m.datas))


@pytest.mark.parametrize("loop", ["single", "stacked", "tempered"])
def test_every_model_path_hands_the_move_what_k7_takes(monkeypatch, loop):
    """The move's inputs on each path, made contiguous as _hmc makes them,
    pass every check of K7's wrapper but the device."""
    m = _model()
    seen = []
    plain = LatentDistanceConfig._hmc_plain

    def spy(self, L, gamma, A, noise, log_ratios=None):
        seen.append((L, gamma, A, noise))
        return plain(self, L, gamma, A, noise, log_ratios)
    monkeypatch.setattr(LatentDistanceConfig, "_hmc_plain", spy)
    step = m.resample_model if loop == "single" else _lanes(
        m, loop == "tempered")
    step()
    assert len(seen) == 1
    L, gamma, A, noise = seen[0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        k7.check_ld_hmc(*(x.contiguous() for x in (
            L, gamma, A, noise.mom_L, noise.mom_gamma, noise.u_hmc)),
            m.network.hmc_steps)
