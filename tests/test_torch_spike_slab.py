"""The spike-and-slab update of pyglm_tpu_torch (ops/ss_cuda.py, the module
of kernels K2 and K3, and models/weights.py) against the JAX package on the
CPU, where every call takes the plain versions of the kernels.

- K2's plain version: Jgg against group_gram_blocks(precision="highest"),
  M0 and the scatter against the mesh path's formulas (weights.py:421-427);
  rtol 1e-4 (float32 sums over T = 2000 in another order).
- _batched_evidence elementwise, rtol 1e-4.
- The whole update with JAX's own noise injected, against
  resample_spike_slab_tspace(precision="highest", group=G): A identical,
  W and b atol 1e-4, u atol 1e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops import ss_cuda

torch.set_num_threads(1)
T, N, B, G = 2000, 12, 4, 4
NG, GB = N // G, G * B
HI = lax.Precision.HIGHEST


def _problem(seed):
    """Design, PG-like omega, psi, kappa, weights and priors as numpy."""
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.15).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (rng.standard_normal((N, N, B)) * A[..., None]).astype(np.float32)
    b = (-1.5 + 0.2 * rng.standard_normal(N)).astype(np.float32)
    w_full = np.asarray(jw.pack_weights(jnp.asarray(A), jnp.asarray(W),
                                        jnp.asarray(b)))
    psi = Xf @ w_full
    omega = (0.05 + 0.2 * rng.random((T, N))).astype(np.float32)
    M = rng.standard_normal((N, N, B, B))
    Lam = (M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(np.float32)
    hyp = dict(mu=(0.1 * rng.standard_normal((N, N, B))).astype(np.float32),
               Lam=Lam,
               logit_rho=rng.normal(-1.0, 0.5, (N, N)).astype(np.float32),
               mu_b=np.full(N, -2.0, np.float32),
               lam_b=np.full(N, 1.0, np.float32))
    return dict(Y=Y, Xf=Xf, w_full=w_full, psi=psi.astype(np.float32),
                omega=omega, kappa=Y - 0.5, hyp=hyp)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("g", [0, 1, NG])
def test_group_pass_plain_matches_jax(g):
    p = _problem(0)
    Xt = p["Xf"].T.copy()
    rng = np.random.default_rng(1)
    u0 = rng.standard_normal((T, N)).astype(np.float32)
    dW = (0.1 * rng.standard_normal((GB, N))).astype(np.float32)
    xp = Xt[(g - 1) * GB:g * GB] if g > 0 else None
    xg = Xt[g * GB:(g + 1) * GB] if g < NG else None
    u = _t(u0)
    m0, jgg, s = ss_cuda.ss_group_pass_plain(
        None if xp is None else _t(xp), None if xg is None else _t(xg),
        _t(p["omega"]), u, _t(dW), want_sum_omega=(g == 0))
    om = jnp.asarray(p["omega"])
    u_ref = jnp.asarray(u0)
    if xp is not None:
        u_ref = u_ref - om * lax.dot_general(
            jnp.asarray(xp), jnp.asarray(dW), (((0,), (0,)), ((), ())),
            precision=HI)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-4,
                               atol=1e-5)
    if xg is None:
        assert m0 is None and jgg is None and s is None
        return
    M0_ref = lax.dot_general(jnp.asarray(xg), u_ref, (((1,), (0,)), ((), ())),
                             precision=HI)
    np.testing.assert_allclose(m0.numpy(), np.asarray(M0_ref), rtol=1e-4,
                               atol=1e-4)
    Jg = np.asarray(jw.group_gram_blocks(jnp.asarray(p["Xf"]), om, B, G,
                                         precision="highest"))[g]
    np.testing.assert_allclose(ss_cuda.unpack_gram(jgg, GB).numpy(), Jg,
                               rtol=1e-4, atol=1e-5)
    assert jgg.shape == (GB * (GB + 1) // 2, N)
    if g == 0:
        np.testing.assert_allclose(s.numpy(), p["omega"].sum(0), rtol=1e-5)


def test_batched_evidence_matches_jax():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((N, B, B))
    Jjj = (M @ np.swapaxes(M, -1, -2) * 5).astype(np.float32)
    M = rng.standard_normal((N, B, B))
    Lam0 = (M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(np.float32)
    m = (3 * rng.standard_normal((N, B))).astype(np.float32)
    mu0 = (0.3 * rng.standard_normal((N, B))).astype(np.float32)
    ld0 = np.log(np.diagonal(np.linalg.cholesky(Lam0), axis1=-2,
                             axis2=-1)).sum(-1).astype(np.float32)
    ref = jw._batched_evidence(*map(jnp.asarray, (m, Jjj, mu0, Lam0, ld0)))
    got = tw._batched_evidence(*map(_t, (m, Jjj, mu0, Lam0, ld0)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def _jax_noise(key):
    """The random numbers _tspace_impl's staged path draws from `key`."""
    keys = jax.random.split(key, NG + 1)
    u_a = np.zeros((NG, G, N), np.float32)
    eps = np.zeros((NG, G, N, B), np.float32)
    for g in range(NG):
        gkeys = jax.random.split(keys[g], G)
        for i in range(G):
            k1, k2 = jax.random.split(gkeys[i])
            u_a[g, i] = np.asarray(jax.random.uniform(k1, (N,)))
            eps[g, i] = np.asarray(jax.random.normal(k2, (N, B)))
    bias = np.asarray(jax.random.normal(keys[NG], (N,)))
    return tw.SpikeSlabNoise(_t(u_a), _t(eps), _t(bias))


@pytest.mark.parametrize("seed", [0, 1])
def test_spike_slab_update_matches_jax_with_injected_noise(seed):
    p = _problem(seed)
    key = jax.random.key(100 + seed)
    hj = jw.EdgeHypers(**{k: jnp.asarray(v) for k, v in p["hyp"].items()})
    A_j, w_j, u_j, s_j = jw.resample_spike_slab_tspace(
        key, jnp.asarray(p["Xf"]), jnp.asarray(p["omega"]),
        jnp.asarray(p["kappa"]), jnp.asarray(p["w_full"]), hj, B,
        precision="highest", group=G, psi=jnp.asarray(p["psi"]),
        Xt=jnp.asarray(p["Xf"].T))
    assert jw.LAST_SS_PATH == "staged"
    ht = tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()})
    A_t, w_t, u_t, s_t = tw.resample_spike_slab_tspace(
        None, _t(p["Xf"].T), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
        _t(p["w_full"]), ht, B, group=G, noise=_jax_noise(key))
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    assert 0 < A_t.sum() < N * N
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5)


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(3)
    A = (rng.random((N, N)) < 0.5).astype(np.float32)
    W = rng.standard_normal((N, N, B)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    ref = np.asarray(jw.pack_weights(*map(jnp.asarray, (A, W, b))))
    got = tw.pack_weights(_t(A), _t(W), _t(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    Wu, bu = tw.unpack_weights(got, N, B)
    np.testing.assert_array_equal(Wu.numpy(), W * A[..., None])
    np.testing.assert_array_equal(bu.numpy(), b)


@pytest.mark.parametrize("N_pre,B_,G_", [(200, 4, 8), (10, 4, 10), (12, 1, 6),
                                         (7, 4, 7)])
def test_auto_group(N_pre, B_, G_):
    assert tw._auto_group(N_pre, B_) == G_


def test_edge_scan_dispatch_plain_on_cpu_rejects_others():
    p = _problem(4)
    Xt = _t(p["Xf"].T)
    u = _t(p["kappa"]) - _t(p["omega"]) * _t(p["psi"])
    m0, jgg, _ = ss_cuda.ss_group_pass(None, Xt[:GB], _t(p["omega"]), u, None)
    ht = {k: _t(v)[:G].contiguous() for k, v in p["hyp"].items()
          if k in ("mu", "Lam", "logit_rho")}
    args = (jgg, m0, _t(p["w_full"][:GB]), ht["mu"], ht["Lam"],
            ht["logit_rho"], torch.rand(G, N), torch.randn(G, N, B))
    dW, a = ss_cuda.ss_edge_scan(*args)
    assert dW.shape == (GB, N) and a.shape == (G, N)
    with pytest.raises(ValueError):
        ss_cuda.ss_edge_scan(*(x.to("meta") for x in args))
    with pytest.raises(ValueError):
        ss_cuda.ss_edge_scan_cuda(*args)
    with pytest.raises(ValueError):
        ss_cuda.ss_group_pass_cuda(None, Xt[:GB], _t(p["omega"]), u, None)
