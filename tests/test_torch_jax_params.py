"""The JAX package's `precision` and `t_chunk` parameters of the
log-likelihood, the dense statistics and the sweep factories, on the CPU.

- make_log_likelihood at each of the four modes equals "highest"
  (torch.equal: psi is a full float32 GEMM at every mode) and matches the
  JAX package's at "highest" (rtol 1e-5), for Bernoulli and the negative
  binomial (an aux); GLM passes its mode; an unknown mode raises.
- sufficient_stats and diag_blocks at t_chunk 64, 512 and 777 (T = 1500:
  24, 3 and 2 chunks, the last padded) against JAX's at the same t_chunk
  (max|diff| / max|J| <= 1e-5), at every mode equal to "highest".
- A dense sweep at t_chunk = 64 runs and hands its t_chunk to the dense
  statistics; GLM, the stacked and tempered sweep factories and geweke_chain
  take it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.models import observations as jo
from pyglm_tpu.models import sweep as js
from pyglm_tpu.models import weights as jw
from pyglm_tpu_torch import NonlinearAutoregressiveModel
from pyglm_tpu_torch.models import observations as to
from pyglm_tpu_torch.models import sweep as ts
from pyglm_tpu_torch.models import weights as tw
from test_torch_dense import B, N, T, _problem, _rel, _t

torch.set_num_threads(1)
MODES = ("highest", "high", "sr", "default")


def _state(seed, family):
    """(numpy Y, Xf, A, W, b, r) of one problem; counts for the NB."""
    rng = np.random.default_rng(seed)
    p = _problem(seed)
    Y = (rng.random((T, N)) < 0.2).astype(np.float32)
    if family == "nb":
        Y = rng.poisson(0.4, (T, N)).astype(np.float32)
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (0.3 * rng.standard_normal((N, N, B)) * A[..., None]).astype(
        np.float32)
    b = (-1.0 + 0.2 * rng.standard_normal(N)).astype(np.float32)
    r = (1.0 + rng.random(N)).astype(np.float32)
    return Y, p["Xf"], A, W, b, r


@pytest.mark.parametrize("family", ["bernoulli", "nb"])
def test_log_likelihood_at_every_mode(family):
    Y, Xf, A, W, b, r = _state(3, family)
    jobs, tobs = ((jo.Bernoulli(), to.Bernoulli()) if family == "bernoulli"
                  else (jo.NegativeBinomial(), to.NegativeBinomial()))
    aux_j = None if family == "bernoulli" else {"r": jnp.asarray(r)}
    aux_t = None if family == "bernoulli" else {"r": _t(r)}
    ref = float(js.make_log_likelihood(jobs, N, B, precision="highest")(
        js.GLMState(jnp.asarray(A), jnp.asarray(W), jnp.asarray(b), aux_j,
                    None), js.GLMData(Y=jnp.asarray(Y), Xf=jnp.asarray(Xf))))
    state = ts.GLMState(_t(A), _t(W), _t(b), aux_t, None)
    data = ts.GLMData(Y=_t(Y), Xf=_t(Xf), Xt=None)
    lls = {m: ts.make_log_likelihood(tobs, N, B, precision=m)(state, data)
           for m in MODES}
    for m in MODES:
        assert torch.equal(lls[m], lls["highest"]), m
    assert abs(float(lls["highest"]) - ref) <= 1e-5 * abs(ref)


def test_glm_passes_its_precision(monkeypatch):
    seen = []
    real = ts.make_log_likelihood

    def spy(obs, N_, B_, precision="highest"):
        seen.append(precision)
        return real(obs, N_, B_, precision=precision)

    import pyglm_tpu_torch.models.glm as glm_mod
    monkeypatch.setattr(glm_mod, "make_log_likelihood", spy)
    Y = (np.random.default_rng(0).random((300, 4)) < 0.2).astype(np.float32)
    lls = {}
    for m in MODES:
        model = NonlinearAutoregressiveModel(4, B=2, L=3, seed=1,
                                             precision=m, device="cpu")
        model.add_data(Y)
        lls[m] = model.log_likelihood()
    assert seen == list(MODES)
    assert len(set(lls.values())) == 1         # fp32 at every mode


def test_unknown_precision_and_t_chunk_raise():
    p = _problem(0)
    X, om, ka = _t(p["Xf"]), _t(p["omega"]), _t(p["kappa"])
    with pytest.raises(ValueError):
        ts.make_log_likelihood(to.Bernoulli(), N, B, precision="fast")
    with pytest.raises(ValueError):
        tw.sufficient_stats(X, om, ka, precision="bf16x3")
    with pytest.raises(ValueError):
        tw.diag_blocks(X, om, B, precision="float32")
    for bad in (0, -64, 2.5, True):
        with pytest.raises(ValueError):
            tw.sufficient_stats(X, om, ka, t_chunk=bad)
        with pytest.raises(ValueError):
            ts.make_gibbs_sweep(to.Bernoulli(), None, N, B, False,
                                t_chunk=bad)
    with pytest.raises(ValueError):
        NonlinearAutoregressiveModel(4, B=2, L=3, t_chunk=0, device="cpu")


@pytest.mark.parametrize("t_chunk", [64, 512, 777])
def test_dense_stats_at_t_chunk_match_jax(t_chunk):
    p = _problem(4)
    Xj, oj, kj = (jnp.asarray(p[k]) for k in ("Xf", "omega", "kappa"))
    X, om, ka = _t(p["Xf"]), _t(p["omega"]), _t(p["kappa"])
    J, h = jw.sufficient_stats(Xj, oj, kj, t_chunk=t_chunk)
    Jd = jw.diag_blocks(Xj, oj, B, t_chunk=t_chunk)
    Jt, ht = tw.sufficient_stats(X, om, ka, t_chunk=t_chunk)
    Jdt = tw.diag_blocks(X, om, B, t_chunk=t_chunk)
    assert _rel(Jt, J) <= 1e-5 and _rel(ht, h) <= 1e-5
    assert _rel(Jdt, Jd) <= 1e-5
    for m in MODES[1:]:
        Jm, hm = tw.sufficient_stats(X, om, ka, t_chunk, m)
        assert torch.equal(Jm, Jt) and torch.equal(hm, ht)
        assert torch.equal(tw.diag_blocks(X, om, B, t_chunk, m), Jdt)


def test_dense_sweep_at_t_chunk_64(monkeypatch):
    seen = []
    real = ts.sufficient_stats

    def spy(Xf, omega, kappa, t_chunk=512, *args, **kw):
        seen.append(t_chunk)
        return real(Xf, omega, kappa, t_chunk, *args, **kw)

    monkeypatch.setattr(ts, "sufficient_stats", spy)
    Y = (np.random.default_rng(2).random((900, 5)) < 0.2).astype(np.float32)
    model = NonlinearAutoregressiveModel(5, B=2, L=4, seed=3, t_chunk=64,
                                         device="cpu")
    model.add_data(Y)
    lls = [model.resample_model()["log_likelihood"] for _ in range(2)]
    assert model.t_chunk == 64 and seen == [64, 64]
    assert all(np.isfinite(float(x)) for x in lls)
    assert np.isfinite(model.W).all()


def test_sweep_factories_take_t_chunk(monkeypatch):
    """The stacked, tempered and Geweke sweep factories take t_chunk (with
    the JAX package's defaults), and fit_ensemble's dense stacked sweep
    hands the model's to the dense statistics."""
    import inspect
    from pyglm_tpu_torch.diagnostics.geweke import geweke_chain
    from pyglm_tpu_torch.models import ensemble, tempering
    for fn, default in ((ts.make_gibbs_sweep, 512),
                        (ensemble.make_stacked_sweep, 512),
                        (ensemble.make_stacked_sweep_sharded, 512),
                        (ensemble.make_stacked_sweep_gspmd, 512),
                        (tempering.make_tempered_sweep, 512),
                        (tempering.make_tempered_sweep_sharded, 512),
                        (tempering.make_tempered_sweep_gspmd, 512),
                        (geweke_chain, 64)):
        assert inspect.signature(fn).parameters["t_chunk"].default \
            == default, fn.__name__
    seen = []
    real = ensemble.sufficient_stats

    def spy(Xf, omega, kappa, t_chunk=512, *args, **kw):
        seen.append(t_chunk)
        return real(Xf, omega, kappa, t_chunk, *args, **kw)

    monkeypatch.setattr(ensemble, "sufficient_stats", spy)
    Y = (np.random.default_rng(5).random((700, 4)) < 0.2).astype(np.float32)
    model = NonlinearAutoregressiveModel(4, B=2, L=3, seed=2, t_chunk=64,
                                         device="cpu")
    model.add_data(Y)
    out = model.fit_ensemble(n_chains=2, n_samples=4)
    assert np.isfinite(out["lls"]).all()
    assert seen and set(seen) == {64}
