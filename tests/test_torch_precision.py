"""Precision modes of pyglm_tpu_torch against the JAX package's dispatch, on
the CPU.

The JAX package runs its fused spike-and-slab kernel only at "default",
"sr" and "high" (``_tspace_impl``); "highest" takes the staged path with the
f32 XLA Gram, and "sr" on the staged path takes the "high" Gram. The port
runs all four and threads the model's precision down to the loop choice,
so "highest" never runs K2 (whose Gram is not fp32 on the card).

- ss_path over the four precisions and a grid, against the JAX rule.
- A model's sweep (and fit_ensemble) at "highest" runs the staged loop, at
  "default", "sr" and "high" on a flagship-shaped problem the fused one.
- The update at "high" and "highest" against JAX's update at the same
  precision with JAX's noise injected: A identical, w atol 1e-4, u atol
  1e-3 (float32 sums over T in another order, as
  tests/test_torch_spike_slab.py). The bf16 modes are held against JAX in
  tests/test_torch_bf16.py.
- "sr" on the staged loop is the "high" update; only "sr" on the fused loop
  draws from the host generator (K2's rounding seeds), so the other modes'
  chains draw the numbers they drew before the bf16 modes existed.
- A forced fused loop under "highest" raises.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyglm_tpu_torch
from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw

torch.set_num_threads(1)
T, N, B, G = 1200, 12, 4, 4
NG = N // G


def _jax_rule(N_pre, B_, lanes, T_, precision):
    """The JAX single-device dispatcher's choice (weights.py, fused branch
    of _tspace_impl), backend tests left out."""
    plan = jw._fused_plan(N_pre, B_, -(-lanes // 128) * 128, 512)
    fused = (precision in ("default", "sr", "high") and plan is not None
             and (plan[0] * B_) % 8 == 0 and B_ <= 8 and T_ >= 384)
    return "fused" if fused else "staged"


@pytest.mark.parametrize("precision", ["high", "highest", "default", "sr"])
@pytest.mark.parametrize("N_pre", [27, 100, 200, 500])
def test_ss_path_matches_jax_dispatch_per_precision(N_pre, precision):
    for chains in (1, 2, 4, 8):
        for T_ in (200, 383, 384, 20_000):
            lanes = chains * N_pre
            assert tw.ss_path(N_pre, 4, lanes, T_, precision=precision) == \
                _jax_rule(N_pre, 4, lanes, T_, precision), (N_pre, lanes, T_)
    if precision == "highest":
        assert tw.ss_path(N_pre, 4, N_pre, 100_000,
                          precision="highest") == "staged"


def _problem(seed):
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.15).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (rng.standard_normal((N, N, B)) * A[..., None]).astype(np.float32)
    b = (-1.5 + 0.2 * rng.standard_normal(N)).astype(np.float32)
    w_full = np.asarray(jw.pack_weights(jnp.asarray(A), jnp.asarray(W),
                                        jnp.asarray(b)))
    M = rng.standard_normal((N, N, B, B))
    hyp = dict(mu=(0.1 * rng.standard_normal((N, N, B))).astype(np.float32),
               Lam=(M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(
                   np.float32),
               logit_rho=rng.normal(-1.0, 0.5, (N, N)).astype(np.float32),
               mu_b=np.full(N, -2.0, np.float32),
               lam_b=np.full(N, 1.0, np.float32))
    return dict(Xf=Xf, w_full=w_full, psi=(Xf @ w_full).astype(np.float32),
                omega=(0.05 + 0.2 * rng.random((T, N))).astype(np.float32),
                kappa=Y - 0.5, hyp=hyp)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_noise(key):
    """The random numbers _tspace_impl's staged path draws from `key`."""
    keys = jax.random.split(key, NG + 1)
    u_a = np.zeros((NG, G, N), np.float32)
    eps = np.zeros((NG, G, N, B), np.float32)
    for g in range(NG):
        for i, gk in enumerate(jax.random.split(keys[g], G)):
            k1, k2 = jax.random.split(gk)
            u_a[g, i] = np.asarray(jax.random.uniform(k1, (N,)))
            eps[g, i] = np.asarray(jax.random.normal(k2, (N, B)))
    bias = np.asarray(jax.random.normal(keys[NG], (N,)))
    return tw.SpikeSlabNoise(_t(u_a), _t(eps), _t(bias))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("precision", ["high", "highest"])
def test_update_matches_jax_at_each_precision(precision, seed):
    """JAX on the CPU takes its staged path at both precisions (no Pallas
    kernel there); the port takes the loop of its own dispatch: fused at
    "high", staged at "highest". Same noise, same A."""
    p = _problem(seed)
    key = jax.random.key(300 + seed)
    hj = jw.EdgeHypers(**{k: jnp.asarray(v) for k, v in p["hyp"].items()})
    A_j, w_j, u_j, _ = jw.resample_spike_slab_tspace(
        key, jnp.asarray(p["Xf"]), jnp.asarray(p["omega"]),
        jnp.asarray(p["kappa"]), jnp.asarray(p["w_full"]), hj, B,
        precision=precision, group=G, psi=jnp.asarray(p["psi"]),
        Xt=jnp.asarray(p["Xf"].T))
    ht = tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()})
    A_t, w_t, u_t, _ = tw.resample_spike_slab_tspace(
        None, _t(p["Xf"].T), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
        _t(p["w_full"]), ht, B, group=G, noise=_jax_noise(key),
        precision=precision)
    assert tw.LAST_SS_PATH == ("fused" if precision == "high" else "staged")
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    assert 0 < A_t.sum() < N * N
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-3)


def _model(precision, seed=0, T_=1000):
    truth = pyglm_tpu_torch.SparseBernoulliGLM(
        16, seed=7, device="cpu",
        net_kwargs=dict(rho_init=0.2, learn_rho=False, mu_bias=-1.5))
    m = pyglm_tpu_torch.SparseBernoulliGLM(16, seed=seed, group=4,
                                           precision=precision, device="cpu")
    m.add_data(truth.generate(T_, keep=False))
    return m


@pytest.mark.parametrize("precision,path", [("high", "fused"),
                                            ("highest", "staged"),
                                            ("default", "fused"),
                                            ("sr", "fused")])
def test_model_sweep_runs_the_loop_of_its_precision(precision, path):
    m = _model(precision)
    assert m.precision == precision
    diag = m.resample_model()
    assert tw.LAST_SS_PATH == path
    assert np.isfinite(diag["log_likelihood"])


@pytest.mark.parametrize("precision,path", [("high", "fused"),
                                            ("highest", "staged"),
                                            ("default", "fused"),
                                            ("sr", "fused")])
def test_fit_ensemble_runs_the_loop_of_its_precision(precision, path):
    out = _model(precision).fit_ensemble(n_chains=2, n_samples=4,
                                         collect="mean")
    assert tw.LAST_SS_PATH == path
    assert np.isfinite(out["lls"]).all()


def test_staged_ensemble_at_the_bf16_modes():
    """T < 384 routes fit_ensemble to the staged loop: at "default" on the
    bf16 Gram (another chain than "high"'s), at "sr" on the "high" Gram
    with no draw from the host generator (the same chain as "high")."""
    runs = {}
    for precision in ("high", "default", "sr"):
        runs[precision] = _model(precision, seed=1, T_=300).fit_ensemble(
            n_chains=2, n_samples=4)
        assert tw.LAST_SS_PATH == "staged"
        assert np.isfinite(runs[precision]["lls"]).all()
    for k in ("A", "W", "bias", "lls"):
        np.testing.assert_array_equal(runs["sr"][k], runs["high"][k])
    assert not np.array_equal(runs["default"]["W"], runs["high"]["W"])


def _update_args(seed):
    p = _problem(seed)
    return (_t(p["Xf"].T), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
            _t(p["w_full"]),
            tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()}))


def test_sr_staged_update_is_the_high_update():
    args = _update_args(3)
    noise = _jax_noise(jax.random.key(3))
    sr = tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                       path="staged", precision="sr")
    high = tw.resample_spike_slab_tspace(None, *args, B, group=G,
                                         noise=noise, path="staged",
                                         precision="high")
    for a, b in zip(sr, high):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["default", "sr", "high", "highest"])
def test_host_generator_drawn_only_at_sr(precision):
    """Only "sr" on the fused loop draws from the host generator (one
    (Ng, 2) draw of the K2 calls' (seed, offset) pairs); its seeds then
    equal noise.sr drawn from the same generator, so the update repeats."""
    args = _update_args(4)
    noise = _jax_noise(jax.random.key(4))
    host = torch.Generator().manual_seed(11)
    state = host.get_state()
    out = tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                        precision=precision,
                                        host_generator=host)
    assert tw.LAST_SS_PATH == ("staged" if precision == "highest"
                               else "fused")
    if precision != "sr":
        assert torch.equal(host.get_state(), state)
        return
    assert not torch.equal(host.get_state(), state)
    again = torch.Generator().manual_seed(11)
    seeds = torch.randint(0, 2 ** 62, (NG, 2), generator=again)
    ref = tw.resample_spike_slab_tspace(None, *args, B, group=G,
                                        noise=noise._replace(sr=seeds),
                                        precision="sr")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="host_generator"):
        tw.resample_spike_slab_tspace(None, *args, B, group=G, noise=noise,
                                      precision="sr")


def test_high_and_highest_give_one_chain_on_the_cpu():
    """On the CPU both modes are float32 plain versions: the fused and the
    staged loop of one seed give the same A."""
    runs = {}
    for precision in ("high", "highest"):
        m = _model(precision, seed=3)
        runs[precision] = m.fit(n_samples=3)["A"]
    np.testing.assert_array_equal(runs["high"], runs["highest"])


def test_forced_fused_loop_under_highest_raises():
    p = _problem(2)
    args = (_t(p["Xf"].T), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
            _t(p["w_full"]),
            tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()}))
    with pytest.raises(ValueError, match="high"):
        tw.resample_spike_slab_tspace(None, *args, B, group=G,
                                      path="fused", precision="highest")
    tw.resample_spike_slab_tspace(None, *args, B, group=G, path="staged",
                                  precision="highest")
    assert tw.LAST_SS_PATH == "staged"


def test_unknown_precision_raises():
    with pytest.raises(ValueError):
        tw.ss_path(200, 4, 200, 100_000, precision="fp16")
    with pytest.raises(ValueError):
        pyglm_tpu_torch.SparseBernoulliGLM(8, precision="fp16", device="cpu")
    with pytest.raises(ValueError):
        tw.group_gram_blocks(torch.ones((9, 300)), torch.ones((300, 3)), 4,
                             2, precision="fp16")
