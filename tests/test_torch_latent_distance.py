"""The latent-distance network prior of pyglm_tpu_torch
(models/networks.py::LatentDistanceConfig) against the JAX package's on the
CPU, at N = 30, dim = 2.

- _logit_rho, edge_hypers (with the +-15 clip), the HMC potential, its
  closed-form gradient (also against the port's own autograd) and _row_ll:
  rtol 1e-5.
- One resample with JAX's momenta, MH uniforms and swap/relocation draws
  injected (HMCNoise): the same acceptance rate, L and gamma atol 1e-4.
- The batched C-chain call equals C single-chain calls (same accepts, L
  and gamma atol 1e-4: the batched products round in another order).
- The initial-state law.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.models import networks as jn
from pyglm_tpu_torch.models import networks as tn
from pyglm_tpu_torch.models.sweep import Generators, init_state_from_prior
from pyglm_tpu_torch.models.observations import make_observation

torch.set_num_threads(1)
N, B, DIM = 30, 4, 2


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _state(seed, gamma=0.5):
    rng = np.random.default_rng(seed)
    L = (0.8 * rng.standard_normal((N, DIM))).astype(np.float32)
    lrho = gamma - ((L[:, None] - L[None]) ** 2).sum(-1)
    A = (rng.random((N, N)) < 1 / (1 + np.exp(-lrho))).astype(np.float32)
    W = (rng.standard_normal((N, N, B)) * A[..., None]).astype(np.float32)
    return L, np.float32(gamma), A, W


def _cfgs(**kw):
    return (jn.LatentDistanceConfig(N=N, B=B, dim=DIM, **kw),
            tn.LatentDistanceConfig(N=N, B=B, dim=DIM, **kw))


def _gens(seed=0):
    return Generators(torch.Generator().manual_seed(seed),
                      torch.Generator().manual_seed(seed + 1))


def test_logit_rho_edge_hypers_match_jax():
    jc, tc = _cfgs(mu_bias=-3.0)
    L, gamma, _, _ = _state(0, gamma=20.0)     # many logits above +15
    np.testing.assert_allclose(
        tc._logit_rho(_t(L), _t(gamma)).numpy(),
        np.asarray(jc._logit_rho(jnp.asarray(L), jnp.asarray(gamma))),
        rtol=1e-5, atol=1e-5)
    mu = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    Sig = np.diag([0.5, 1.0, 2.0, 1.5]).astype(np.float32)
    hj = jc.edge_hypers(jn.LatentDistanceState(
        jnp.asarray(L), jnp.asarray(gamma), jnp.asarray(mu),
        jnp.asarray(Sig)))
    ht = tc.edge_hypers(tn.LatentDistanceState(
        _t(L), _t(gamma), _t(mu), _t(Sig), _t(0.0)), "cpu")
    assert float(ht.logit_rho.max()) == 15.0
    for got, ref in zip(ht, hj):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def _jax_potential(jc, L, gamma, A):
    """The potential of JAX's resample (a closure there), on its formula."""
    lrho = jc._logit_rho(L, gamma)
    ll = jnp.sum(A * lrho - jnp.logaddexp(lrho, 0.0))
    lp = (-0.5 * jnp.sum(L ** 2) / jc.sigma_l ** 2
          - 0.5 * gamma ** 2 / jc.sigma_gamma ** 2)
    return -(ll + lp)


@pytest.mark.parametrize("seed", [1, 2])
def test_potential_and_gradient_match_jax_and_autograd(seed):
    jc, tc = _cfgs()
    L, gamma, A, _ = _state(seed)
    Lj, gj, Aj = jnp.asarray(L), jnp.asarray(gamma), jnp.asarray(A)
    Ut = tc._potential(_t(L), _t(gamma), _t(A))
    np.testing.assert_allclose(float(Ut), float(_jax_potential(jc, Lj, gj,
                                                               Aj)),
                               rtol=1e-5)
    gL, gg = tc._potential_grad(_t(L), _t(gamma), _t(A))
    rL, rg = jc._potential_grad((Lj, gj), Aj)
    np.testing.assert_allclose(gL.numpy(), np.asarray(rL), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(float(gg), float(rg), rtol=1e-5, atol=1e-4)
    Lv = _t(L).double().requires_grad_()
    gv = _t(gamma).double().requires_grad_()
    tc._potential(Lv, gv, _t(A).double()).backward()
    gL64, gg64 = tc._potential_grad(_t(L).double(), _t(gamma).double(),
                                    _t(A).double())
    np.testing.assert_allclose(gL64.numpy(), Lv.grad.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(float(gg64), float(gv.grad), rtol=1e-10)


def test_row_ll_matches_jax():
    jc, tc = _cfgs()
    L, gamma, A, _ = _state(3)
    rng = np.random.default_rng(4)
    for i in (0, 7, N - 1):
        pos = rng.standard_normal(DIM).astype(np.float32)
        ref = jc._row_ll(jnp.asarray(L), jnp.asarray(gamma),
                         jnp.asarray(pos), i, jnp.asarray(A))
        got = tc._row_ll(_t(L)[None], _t(gamma)[None], _t(pos)[None],
                         torch.tensor([i]), _t(A)[None])
        np.testing.assert_allclose(float(got[0]), float(ref), rtol=1e-5)


def _jax_noise(jc, key):
    """HMCNoise (C = 1) holding the draws JAX's resample takes from `key`."""
    k_hmc, _ = jax.random.split(key)
    mL, mg, uh = [], [], []
    for k in jax.random.split(jax.random.fold_in(k_hmc, 0), jc.hmc_iters):
        k_m1, k_m2, k_a = jax.random.split(k, 3)
        mL.append(np.asarray(jax.random.normal(k_m1, (N, DIM))))
        mg.append(float(jax.random.normal(k_m2, ())))
        uh.append(float(jax.random.uniform(k_a, ())))
    ij, us = [], []
    for k in jax.random.split(jax.random.fold_in(k_hmc, 1),
                              max(jc.swap_moves, 1))[:jc.swap_moves]:
        k_ij, k_a = jax.random.split(k)
        ij.append(np.asarray(jax.random.randint(k_ij, (2,), 0, N)))
        us.append(float(jax.random.uniform(k_a, ())))
    ri, rz, ur = [], [], []
    for k in jax.random.split(jax.random.fold_in(k_hmc, 2),
                              max(jc.relocate_moves, 1))[:jc.relocate_moves]:
        k_i, k_p, k_a = jax.random.split(k, 3)
        ri.append(int(jax.random.randint(k_i, (), 0, N)))
        rz.append(np.asarray(jax.random.normal(k_p, (DIM,))))
        ur.append(float(jax.random.uniform(k_a, ())))
    s, r = jc.swap_moves, jc.relocate_moves
    return tn.HMCNoise(
        _t(mL)[None], _t(mg)[None], _t(uh)[None],
        torch.tensor(np.array(ij, np.int64).reshape(1, s, 2)),
        _t(us).reshape(1, s), torch.tensor(np.array(ri, np.int64)).reshape(
            1, r), _t(np.array(rz, np.float32).reshape(1, r, DIM)),
        _t(ur).reshape(1, r))


@pytest.mark.parametrize("kw", [
    dict(),                                           # default eps, ~all accept
    dict(hmc_eps=0.09, hmc_iters=6),                  # large steps: rejections
    dict(hmc_iters=3, swap_moves=15, relocate_moves=15)])
def test_resample_matches_jax_with_injected_noise(kw):
    jc, tc = _cfgs(**kw)
    L, gamma, A, W = _state(5)
    key = jax.random.key(31)
    mu, Sig = np.zeros(B, np.float32), np.eye(B, dtype=np.float32)
    sj = jc.resample(key, jn.LatentDistanceState(
        jnp.asarray(L), jnp.asarray(gamma), jnp.asarray(mu),
        jnp.asarray(Sig)), jnp.asarray(A), jnp.asarray(W))
    st = tc.resample(_gens(), tn.LatentDistanceState(
        _t(L), _t(gamma), _t(mu), _t(Sig), _t(0.0)), _t(A), _t(W),
        noise=_jax_noise(jc, key))
    assert float(st.hmc_accept) == pytest.approx(float(sj.hmc_accept),
                                                 abs=1e-6)
    np.testing.assert_allclose(st.L.numpy(), np.asarray(sj.L), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(st.gamma), float(sj.gamma), rtol=0,
                               atol=1e-4)
    assert not np.allclose(st.L.numpy(), L)                  # it moved
    assert st.mu.shape == (B,) and st.Sigma.shape == (B, B)
    assert torch.isfinite(st.Sigma).all()
    if "hmc_eps" in kw:
        assert 0 < float(st.hmc_accept) < 1


def test_batched_chains_equal_single_chain_calls():
    # eps = 0.07 rejects some trajectories; at 0.09 the leapfrog amplifies
    # rounding differences to ~1e-3 over a trajectory.
    _, tc = _cfgs(hmc_eps=0.07, hmc_iters=4, swap_moves=5, relocate_moves=5)
    C = 3
    states, As, Ws = [], [], []
    for c in range(C):
        L, gamma, A, W = _state(10 + c, gamma=0.2 * c)
        states.append(tn.LatentDistanceState(
            _t(L), _t(gamma), torch.zeros(B), torch.eye(B), _t(0.0)))
        As.append(_t(A))
        Ws.append(_t(W))
    noise = tc.draw_noise(torch.Generator().manual_seed(3), C, "cpu")
    stacked = tn.LatentDistanceState(*map(torch.stack, zip(*states)))
    out = tc.resample(_gens(), stacked, torch.stack(As), torch.stack(Ws),
                      noise=noise)
    assert out.L.shape == (C, N, DIM) and out.hmc_accept.shape == (C,)
    for c in range(C):
        nc = tn.HMCNoise(*(x[c:c + 1] for x in noise))
        one = tc.resample(_gens(), states[c], As[c], Ws[c], noise=nc)
        assert one.L.shape == (N, DIM) and one.hmc_accept.shape == ()
        assert float(one.hmc_accept) == float(out.hmc_accept[c])
        # atol 1e-4, as against JAX: the batched products round otherwise
        np.testing.assert_allclose(one.L.numpy(), out.L[c].numpy(),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(one.gamma), float(out.gamma[c]),
                                   rtol=0, atol=1e-4)
    assert not torch.allclose(out.L[0], out.L[1])
    assert float(out.hmc_accept.min()) < 1


def test_init_state_law():
    tc = tn.LatentDistanceConfig(N=2000, B=B, dim=3, sigma_l=1.5,
                                 gamma_init=-0.5, sigma_w=0.3)
    s = tc.init_state(_gens(7))
    assert s.L.shape == (2000, 3)
    assert abs(float(s.L.mean())) < 5 * 1.5 / np.sqrt(6000)
    assert abs(float(s.L.std()) / 1.5 - 1) < 0.05
    assert float(s.gamma) == -0.5 and float(s.hmc_accept) == 0.0
    torch.testing.assert_close(s.Sigma, 0.3 * torch.eye(B))
    assert torch.equal(s.mu, torch.zeros(B))
    # A ~ Bern(logistic(clip(logit rho))) under the drawn positions.
    cfg = tn.LatentDistanceConfig(N=400, B=B, dim=2, mu_bias=-3.0)
    st = init_state_from_prior(_gens(8), make_observation("bernoulli"), cfg,
                               400, B, True, "cpu")
    p = torch.sigmoid(cfg.edge_hypers(st.net, "cpu").logit_rho)
    z = float((st.A - p).sum() / torch.sqrt((p * (1 - p)).sum()))
    assert abs(z) < 5
    assert torch.all(st.W[st.A == 0] == 0)


def test_single_chain_sweep_reports_hmc_accept():
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    kw = dict(network="latent_distance", spike_and_slab=True, device="cpu",
              net_kwargs=dict(hmc_iters=4, hmc_steps=10))
    truth = NonlinearAutoregressiveModel(8, seed=1, **kw)
    m = NonlinearAutoregressiveModel(8, seed=2, **kw)
    m.add_data(truth.generate(400, keep=False))
    L0 = m.state.net.L.clone()
    diag = m.resample_model()
    assert set(diag) == {"log_likelihood", "n_edges", "hmc_accept"}
    assert diag["hmc_accept"] in (0.0, 0.25, 0.5, 0.75, 1.0)
    assert m.state.net.L.shape == (8, 2) and m.state.net.gamma.shape == ()
    assert diag["hmc_accept"] == 0.0 or not torch.equal(m.state.net.L, L0)
