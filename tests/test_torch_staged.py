"""The staged spike-and-slab loop of pyglm_tpu_torch (models/weights.py:
kernel K6's Gram, then per group M0, the edge scan K3 and the scatter)
against the JAX package's staged path on the CPU, and against the port's
own K2 loop; and the dispatch predicate against the JAX package's.

- With JAX's noise injected: A identical, w atol 1e-4, u atol 1e-3 (as
  tests/test_torch_spike_slab.py holds the K2 loop).
- Staged and K2 loop on one noise: A identical, w atol 1e-4; on one
  generator seed, three sweeps of chained updates: A identical.
- ss_path against the JAX dispatcher's own rule over a grid.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw

torch.set_num_threads(1)
T, N, B, G = 1500, 12, 4, 3
NG, GB = N // G, G * B


def _problem(seed, lanes=N):
    """Design, PG-like omega, psi, kappa, weights and priors as numpy."""
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.15).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))
    A = (rng.random((N, lanes)) < 0.4).astype(np.float32)
    W = (rng.standard_normal((N, lanes, B)) * A[..., None]).astype(np.float32)
    b = (-1.5 + 0.2 * rng.standard_normal(lanes)).astype(np.float32)
    w_full = np.concatenate([W.transpose(0, 2, 1).reshape(N * B, lanes),
                             b[None]]).astype(np.float32)
    omega = (0.05 + 0.2 * rng.random((T, lanes))).astype(np.float32)
    M = rng.standard_normal((N, lanes, B, B))
    Lam = (M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(np.float32)
    Yl = Y[:, rng.integers(0, N, lanes)]
    hyp = dict(mu=(0.1 * rng.standard_normal((N, lanes, B))).astype(
                   np.float32),
               Lam=Lam,
               logit_rho=rng.normal(-1.0, 0.5, (N, lanes)).astype(np.float32),
               mu_b=np.full(lanes, -2.0, np.float32),
               lam_b=np.full(lanes, 1.0, np.float32))
    return dict(Xf=Xf, w_full=w_full, psi=(Xf @ w_full).astype(np.float32),
                omega=omega, kappa=Yl - 0.5, hyp=hyp)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _port_args(p):
    return (_t(p["Xf"].T), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
            _t(p["w_full"]),
            tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()}))


def _jax_noise(key, lanes=N):
    """The random numbers _tspace_impl's staged path draws from `key`."""
    keys = jax.random.split(key, NG + 1)
    u_a = np.zeros((NG, G, lanes), np.float32)
    eps = np.zeros((NG, G, lanes, B), np.float32)
    for g in range(NG):
        for i, gk in enumerate(jax.random.split(keys[g], G)):
            k1, k2 = jax.random.split(gk)
            u_a[g, i] = np.asarray(jax.random.uniform(k1, (lanes,)))
            eps[g, i] = np.asarray(jax.random.normal(k2, (lanes, B)))
    bias = np.asarray(jax.random.normal(keys[NG], (lanes,)))
    return tw.SpikeSlabNoise(_t(u_a), _t(eps), _t(bias))


@pytest.mark.parametrize("seed", [0, 1])
def test_staged_matches_jax_with_injected_noise(seed):
    p = _problem(seed)
    key = jax.random.key(200 + seed)
    hj = jw.EdgeHypers(**{k: jnp.asarray(v) for k, v in p["hyp"].items()})
    A_j, w_j, u_j, s_j = jw.resample_spike_slab_tspace(
        key, jnp.asarray(p["Xf"]), jnp.asarray(p["omega"]),
        jnp.asarray(p["kappa"]), jnp.asarray(p["w_full"]), hj, B,
        precision="highest", group=G, psi=jnp.asarray(p["psi"]),
        Xt=jnp.asarray(p["Xf"].T))
    assert jw.LAST_SS_PATH == "staged"
    A_t, w_t, u_t, s_t = tw.resample_spike_slab_tspace(
        None, *_port_args(p), B, group=G, noise=_jax_noise(key),
        path="staged")
    assert tw.LAST_SS_PATH == "staged"
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    assert 0 < A_t.sum() < N * N
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5)


def test_staged_and_fused_loops_agree_on_one_noise():
    p = _problem(2)
    noise = _jax_noise(jax.random.key(7))
    outs = {path: tw.resample_spike_slab_tspace(
        None, *_port_args(p), B, group=G, noise=noise, path=path,
        precision="high")
        for path in ("staged", "fused")}
    (A_s, w_s, u_s, s_s), (A_f, w_f, u_f, s_f) = outs["staged"], outs["fused"]
    np.testing.assert_array_equal(A_s.numpy(), A_f.numpy())
    np.testing.assert_allclose(w_s.numpy(), w_f.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(u_s.numpy(), u_f.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(s_s.numpy(), s_f.numpy(), rtol=1e-6)


def test_staged_and_fused_loops_give_one_chain_on_one_seed():
    """Both loops draw their noise in the same order, so one generator
    seed gives the same chain: three chained updates, A identical."""
    p = _problem(3)
    Xt, omega, kappa, psi, w0, hyp = _port_args(p)
    chains = {}
    for path in ("staged", "fused"):
        gen = torch.Generator().manual_seed(11)
        w, As = w0, []
        for _ in range(3):
            A, w, u, _ = tw.resample_spike_slab_tspace(
                gen, Xt, omega, kappa, psi, w, hyp, B, group=G, path=path,
                precision="high")
            psi = (kappa - u) / omega
            As.append(A)
        chains[path] = (torch.stack(As), w)
        psi = _t(p["psi"])
    np.testing.assert_array_equal(chains["staged"][0].numpy(),
                                  chains["fused"][0].numpy())
    np.testing.assert_allclose(chains["staged"][1].numpy(),
                               chains["fused"][1].numpy(), rtol=0, atol=1e-3)


def _jax_rule(N_pre, B_, lanes, T_, group=None):
    """The JAX single-device dispatcher's choice at precision "high" (the
    bf16 modes are held in tests/test_torch_precision.py), backend tests
    left out."""
    plan = jw._fused_plan(N_pre, B_, -(-lanes // 128) * 128, 512, group=group)
    fused = (plan is not None and (plan[0] * B_) % 8 == 0 and B_ <= 8
             and T_ >= 384)
    return "fused" if fused else "staged"


@pytest.mark.parametrize("N_pre", [27, 100, 200, 500])
def test_ss_path_matches_jax_dispatch(N_pre):
    for chains in (1, 2, 4, 8):
        for T_ in (200, 383, 384, 20_000):
            lanes = chains * N_pre
            assert tw.ss_path(N_pre, 4, lanes, T_,
                              precision="high") == _jax_rule(
                N_pre, 4, lanes, T_), (N_pre, lanes, T_)
            assert tw._fused_plan(N_pre, 4, -(-lanes // 128) * 128, 512) == \
                jw._fused_plan(N_pre, 4, -(-lanes // 128) * 128, 512)
    assert tw.ss_path(N_pre, 4, N_pre, 20_000, group=5,
                      precision="high") == _jax_rule(
        N_pre, 4, N_pre, 20_000, group=5)


def test_ss_path_landmarks():
    hi = dict(precision="high")
    assert tw.ss_path(500, 4, 8 * 500, 20_000, **hi) == "staged"  # config 5
    assert tw._fused_plan(500, 4, 4096, 512) is None
    assert tw.ss_path(200, 4, 200, 100_000, **hi) == "fused"      # flagship
    assert tw._fused_plan(200, 4, 256, 512) == (8, 1024)
    assert tw.ss_path(200, 4, 200, 100_000) == "staged"     # "highest"
    assert tw.ss_path(200, 4, 200, 383, **hi) == "staged"         # short T
    assert tw.ss_path(200, 4, 200, 20_000, jg_given=True,
                      **hi) == "staged"
    assert tw.ss_path(200, 9, 200, 20_000, **hi) == "staged"      # B > 8
    assert tw.ss_path(10, 4, 10, 3000, group=5, **hi) == "staged"  # GB % 8


def test_given_gram_runs_the_staged_loop():
    p = _problem(4)
    args = _port_args(p)
    noise = _jax_noise(jax.random.key(9))
    Jg = tw.group_gram_blocks(args[0], args[1], B, G)
    got = tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                        Jg=Jg)
    assert tw.LAST_SS_PATH == "staged"
    ref = tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                        path="staged")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="staged"):
        tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                      Jg=Jg, path="fused", precision="high")
