"""The stochastic-block-model prior of pyglm_tpu_torch
(models/networks.py::SBMConfig) against the JAX package's on the CPU.

- The (K, K, N, N) edge tables against JAX's on the same state: rtol 1e-5
  (atol 1e-6).
- The label scan's logits for each neuron given the same labels, against
  JAX's scan body (the self-edge counted once): within 1e-5 of the largest
  |logit|.
- The label draw's law (inverse CDF at the host generator's uniforms):
  a chi-square test of 20000 draws against the softmax, p > 1e-3; the
  Dirichlet and Beta draws by KS tests against scipy, p > 1e-3.
- SBM models construct, add_data, fit and fit_ensemble; make_network maps
  the JAX package's names.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

import pyglm_tpu_torch
from pyglm_tpu.models import networks as jn
from pyglm_tpu_torch.models import networks as tn
from pyglm_tpu_torch.ops.linalg import sample_beta, sample_dirichlet

torch.set_num_threads(1)
N, B, K = 9, 3, 3


def _state(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, K, N)
    pi = rng.dirichlet(np.ones(K)).astype(np.float32)
    rho = rng.uniform(0.05, 0.9, (K, K)).astype(np.float32)
    mu = (0.3 * rng.standard_normal((K, K, B))).astype(np.float32)
    M = rng.standard_normal((K, K, B, B))
    Sigma = (M @ np.swapaxes(M, -1, -2) / B + 0.5 * np.eye(B)).astype(
        np.float32)
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (rng.standard_normal((N, N, B)) * A[..., None]).astype(np.float32)
    return (c, pi, rho, mu, Sigma), A, W


def _tables(seed):
    (c, pi, rho, mu, Sigma), A, W = _state(seed)
    jcfg, tcfg = jn.SBMConfig(N=N, B=B, K=K), tn.SBMConfig(N=N, B=B, K=K)
    jt = jcfg._edge_tables(jn.SBMState(jnp.asarray(c, jnp.int32), *map(
        jnp.asarray, (pi, rho, mu, Sigma))), jnp.asarray(A), jnp.asarray(W))
    tt = tcfg._edge_tables(tn.SBMState(torch.tensor(c), *map(
        torch.tensor, (pi, rho, mu, Sigma))), torch.tensor(A),
        torch.tensor(W))
    return np.asarray(jt), tt.numpy(), c, pi


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_tables_match_jax(seed):
    jt, tt, _, _ = _tables(seed)
    assert tt.shape == (K, K, N, N)
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-6)


def _jax_logits(tbl, c, pi, n):
    """The JAX scan body's logits (networks.py:319-334), in numpy."""
    onehot = np.eye(K)[c]
    tblT = tbl.transpose(0, 1, 3, 2)
    out_t, in_t = tbl[:, :, n, :], tblT[:, :, n, :]
    masked = onehot * (1.0 - np.eye(N)[n])[:, None]
    ll_out = np.einsum("xpm,mp->x", out_t, masked)
    ll_in = np.einsum("pxm,mp->x", in_t, masked)
    return np.log(pi + 1e-12) + ll_out + ll_in + np.diagonal(
        out_t[:, :, n])


def test_label_logits_match_jax():
    jt, tt, c, pi = _tables(2)
    cfg = tn.SBMConfig(N=N, B=B, K=K)
    t_out, t_in, self_ll = (x.numpy() for x in cfg._scan_tables(
        torch.from_numpy(tt.astype(np.float64))))
    for n in range(N):
        onehot = np.eye(K)[c]
        onehot[n] = 0.0
        got = cfg._label_logits(t_out[n], t_in[n], self_ll[n],
                                np.log(pi + 1e-12), onehot.reshape(-1))
        want = _jax_logits(jt, c, pi, n)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), n


def test_label_draw_law():
    """One neuron, no edges to others: the scan draws its label from the
    softmax of log pi + its self-edge term."""
    cfg = tn.SBMConfig(N=1, B=1, K=K)
    tbl = torch.zeros((K, K, 1, 1), dtype=torch.float64)
    tbl[torch.arange(K), torch.arange(K), 0, 0] = torch.tensor(
        [0.0, 1.0, -0.5], dtype=torch.float64)
    tabs = [x.numpy() for x in cfg._scan_tables(tbl)]
    pi = np.array([0.5, 0.2, 0.3])
    g = torch.Generator().manual_seed(3)
    u = torch.rand((20000,), generator=g, dtype=torch.float64).numpy()
    draws = [cfg._label_scan(*tabs, np.zeros(1, np.int64), pi,
                             u[i:i + 1])[0] for i in range(u.size)]
    p = pi * np.exp([0.0, 1.0, -0.5])
    p /= p.sum()
    counts = np.bincount(draws, minlength=K)
    assert stats.chisquare(counts, p * u.size).pvalue > 1e-3


def test_dirichlet_and_beta_laws():
    g = torch.Generator().manual_seed(4)
    alpha = torch.tensor([0.7, 2.0, 5.0])
    d = torch.stack([sample_dirichlet(alpha, g) for _ in range(3000)])
    assert torch.allclose(d.sum(-1), torch.ones(3000), atol=1e-6)
    for k in range(3):     # each coordinate is Beta(a_k, sum - a_k)
        law = stats.beta(float(alpha[k]), float(alpha.sum() - alpha[k]))
        assert stats.kstest(d[:, k].numpy(), law.cdf).pvalue > 1e-3, k
    x = sample_beta(torch.full((4000,), 2.5), torch.full((4000,), 0.8), g)
    assert stats.kstest(x.numpy(), stats.beta(2.5, 0.8).cdf).pvalue > 1e-3


def test_make_network_names():
    for name, cls in (("dense", tn.DenseNetworkConfig),
                      ("er", tn.ErdosRenyiConfig),
                      ("sparse", tn.ErdosRenyiConfig),
                      ("sbm", tn.SBMConfig),
                      ("stochastic_block", tn.SBMConfig),
                      ("distance", tn.LatentDistanceConfig)):
        assert type(tn.make_network(name, 4, 2)) is cls, name
        assert type(jn.make_network(name, 4, 2)).__name__ == cls.__name__
    with pytest.raises(ValueError):
        tn.make_network("ring", 4, 2)


def test_edge_hypers_gather_the_blocks():
    (c, pi, rho, mu, Sigma), _, _ = _state(5)
    cfg = tn.SBMConfig(N=N, B=B, K=K)
    st = tn.SBMState(torch.tensor(c), *map(torch.tensor,
                                           (pi, rho, mu, Sigma)))
    hyp = cfg.edge_hypers(st, "cpu")
    jhyp = jn.SBMConfig(N=N, B=B, K=K).edge_hypers(jn.SBMState(
        jnp.asarray(c, jnp.int32), *map(jnp.asarray, (pi, rho, mu, Sigma))))
    for k in ("mu", "Lam", "logit_rho", "mu_b", "lam_b"):
        np.testing.assert_allclose(getattr(hyp, k).numpy(),
                                   np.asarray(getattr(jhyp, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("spike_slab", [True, False])
def test_sbm_model_fits(spike_slab):
    m = pyglm_tpu_torch.NonlinearAutoregressiveModel(
        8, B=2, L=4, network="sbm", spike_and_slab=spike_slab, seed=6,
        device="cpu", net_kwargs=dict(K=2, rho_init=0.3, mu_bias=-1.5))
    m.add_data(m.generate(800, keep=False))
    out = m.fit(n_samples=3)
    net = m.state.net
    assert net.c.dtype == torch.int64 and net.c.shape == (8,)
    assert torch.allclose(net.pi.sum(), torch.tensor(1.0))
    assert net.rho.shape == (2, 2) and net.Sigma.shape == (2, 2, 2, 2)
    assert np.isfinite(out["lls"]).all()
    ens = m.fit_ensemble(n_chains=2, n_samples=4)
    assert np.isfinite(ens["lls"]).all() and ens["A"].shape == (2, 4, 8, 8)
