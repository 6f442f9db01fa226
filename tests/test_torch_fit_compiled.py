"""NonlinearAutoregressiveModel.fit_compiled and fit_ensemble's `compiled`
in pyglm_tpu_torch, on the CPU.

- fit_compiled equals fit sample for sample from the same generators
  (every array equal, not close), across segments of several lengths;
  thin > max_sweeps_per_launch raises ValueError; a burn-only call returns
  correctly shaped empty arrays.
- fit_ensemble takes the JAX package's signature (`compiled` sixth,
  `stacked` seventh): the same positional arguments take the same path in
  both packages (stacked, sequential fit_compiled, sequential fit).
"""
import numpy as np
import pytest
import torch

import pyglm_tpu
import pyglm_tpu_torch as pt
from pyglm_tpu.models import ensemble as jens
from pyglm_tpu_torch.models import glm as tglm

torch.set_num_threads(1)
NET = dict(rho_init=0.3, learn_rho=False, mu_bias=-1.5, sigma_bias=0.3,
           sigma_w=0.8, learn_weight_prior=False)


def _pair(**kw):
    Y = pt.SparseBernoulliGLM(6, B=2, L=5, seed=42, net_kwargs=NET,
                              device="cpu").generate(500, keep=False)
    ms = []
    for _ in range(2):
        m = pt.NonlinearAutoregressiveModel(6, B=2, L=5, seed=0,
                                            device="cpu", **kw)
        m.add_data(Y)
        ms.append(m)
    return ms


@pytest.mark.parametrize("kw,thin,cap", [
    (dict(network="erdos_renyi", spike_and_slab=True, net_kwargs=NET), 2, 5),
    (dict(network="erdos_renyi", spike_and_slab=True, net_kwargs=NET), 1, 3),
    (dict(), 3, 250),                                   # the dense default
])
def test_fit_compiled_equals_fit(kw, thin, cap):
    a, b = _pair(**kw)
    ref = a.fit(n_samples=7, n_burnin=3, thin=thin)
    got = b.fit_compiled(n_samples=7, n_burnin=3, thin=thin,
                         max_sweeps_per_launch=cap)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # The chains end in the same state.
    for f in ("A", "W", "b"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f))


def test_fit_compiled_contract():
    (m,) = _pair(network="erdos_renyi", spike_and_slab=True,
                 net_kwargs=NET)[:1]
    with pytest.raises(ValueError, match="max_sweeps_per_launch"):
        m.fit_compiled(n_samples=2, thin=5, max_sweeps_per_launch=4)
    out = m.fit_compiled(n_samples=0, n_burnin=2)
    shapes = {"A": (0, 6, 6), "W": (0, 6, 6, 2), "bias": (0, 6),
              "lls": (0,)}
    assert {k: v.shape for k, v in out.items()} == shapes
    assert all(v.dtype == np.float32 for v in out.values())


class _Took(Exception):
    """Raised by a stub with the path it stands for."""


@pytest.mark.parametrize("args", [
    (2, 4, 0, 1, None),                  # defaults: compiled, stacked auto
    (2, 4, 0, 1, None, True),
    (2, 4, 0, 1, None, False),           # auto -> sequential fit
    (2, 4, 0, 1, None, True, False),     # sequential fit_compiled
    (2, 4, 0, 1, None, False, True),     # stacked
])
def test_fit_ensemble_positional_arguments_take_jax_paths(args, monkeypatch):
    def stub(name):
        def f(*a, **k):
            raise _Took(name)
        return f

    paths = []
    for pkg, module, attr in ((pyglm_tpu, jens, "run_stacked_chains"),
                              (pt, tglm, "run_stacked_chains")):
        m = pkg.SparseBernoulliGLM(4, B=2, L=4, seed=0,
                                   **({} if pkg is pyglm_tpu
                                      else {"device": "cpu"}))
        m.generate(100, keep=True)
        monkeypatch.setattr(module, attr, stub("stacked"))
        m.fit = stub("fit")
        m.fit_compiled = stub("fit_compiled")
        with pytest.raises(_Took) as e:
            m.fit_ensemble(*args)
        paths.append(str(e.value))
    assert paths[0] == paths[1], paths
