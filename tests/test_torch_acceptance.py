"""The port's acceptance runner (pyglm_tpu_torch/acceptance.py) against the
JAX package's benchmarks/acceptance.py: the same floors for all five
configs, the same gate verdicts on the same results, a --quick run of
config 3 on the CPU that writes every field of the report, and --quick runs
of configs 1 (dense) and 4 (SBM). Also: the
port's config-2 truth (seed 2) is supercritical in the JAX package's
generator too, so its runaway is the draw's, not the port generator's.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pyglm_tpu_torch import acceptance as acc

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _jax_acceptance():
    spec = importlib.util.spec_from_file_location(
        "jax_acceptance", ROOT / "benchmarks" / "acceptance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_thresholds_equal_jax():
    jax_thr = _jax_acceptance().THRESHOLDS
    assert set(acc.THRESHOLDS) == set(acc.CONFIGS)
    for name in acc.CONFIGS:
        assert acc.THRESHOLDS[name] == jax_thr[name], name


RESULTS = [
    # all floors met
    [{"config": "3_spike_slab", "link_auc": 0.96, "weight_corr": 0.95,
      "pred_ll_gap_per_bin": 0.0015}],
    # one floor missed, one metric missing, an ensemble-suffixed name
    [{"config": "2_negative_binomial", "link_auc": 0.80, "weight_corr": 0.9,
      "pred_ll_gap_per_bin": 0.001},
     {"config": "5_latent_distance_ensemble", "link_auc": 0.87,
      "pred_ll_gap_per_bin": 0.05}],
    # exactly at the bounds
    [{"config": "3_spike_slab", "link_auc": 0.93, "weight_corr": 0.93,
      "pred_ll_gap_per_bin": 0.004},
     {"config": "2_negative_binomial", "link_auc": 0.86,
      "weight_corr": 0.85, "pred_ll_gap_per_bin": 0.003}],
    # a refused (runaway) config: no metrics
    [{"config": "2_negative_binomial", "truth_runaway": {}}],
    [],
]


@pytest.mark.parametrize("i", range(len(RESULTS)))
def test_check_gates_agrees_with_jax(i):
    assert acc.check_gates(RESULTS[i]) == _jax_acceptance().check_gates(
        RESULTS[i])


def test_quick_config3_writes_every_field(tmp_path):
    out = tmp_path / "report.json"
    rc = acc.main(["--quick", "--only", "3_spike", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert {"quick", "precision", "card", "results", "threshold_semantics",
            "thresholds", "gate"} <= set(rep)
    assert rep["quick"] and rep["card"] == "cpu"
    assert rep["gate"]["evaluated"] is False
    (res,) = rep["results"]
    fields = ("config", "N", "T", "precision", "rate", "sweeps",
              "sweeps_per_sec", "link_auc", "weight_corr", "pred_ll_model",
              "pred_ll_truth", "pred_ll_gap_per_bin", "generate_s")
    assert set(fields) <= set(res), set(fields) - set(res)
    assert res["config"] == "3_spike_slab" and res["T"] == 5000
    assert res["sweeps"] == [10, 5]
    for k in ("rate", "sweeps_per_sec", "link_auc", "weight_corr",
              "pred_ll_model", "pred_ll_truth", "pred_ll_gap_per_bin",
              "generate_s"):
        assert np.isfinite(res[k]), k
    assert 0.0 <= res["link_auc"] <= 1.0


@pytest.mark.parametrize("name", ["1_bernoulli_dense", "4_sbm"])
def test_quick_configs_1_and_4(name):
    res = acc.run(name, True, "high", "cpu")
    assert res["config"] == name and res["T"] == 5000
    assert res["sweeps"] == [10, 5]
    want = ["rate", "sweeps_per_sec", "weight_corr", "pred_ll_model",
            "pred_ll_truth", "pred_ll_gap_per_bin", "generate_s"]
    # Config 1's truth is dense: every edge is present, so no AUC.
    assert ("link_auc" in res) == (name == "4_sbm")
    for k in want + (["link_auc"] if name == "4_sbm" else []):
        assert np.isfinite(res[k]), k
    passed, failures = acc.check_gates([dict(res, weight_corr=1.0,
                                             link_auc=1.0,
                                             pred_ll_gap_per_bin=0.0)])
    assert passed, failures


def test_config2_truth_runs_away_in_both_generators():
    """The port's config-2 truth, carried into the JAX package's model,
    runs away there too: a count above max_y within 100 bins in both."""
    import jax.numpy as jnp
    import pyglm_tpu
    from pyglm_tpu_torch.utils.convert import state_to_numpy

    port = acc.make_truth("2_negative_binomial", "cpu")
    Yp = port.generate(100, keep=False)
    s = state_to_numpy(port.state)
    jm = pyglm_tpu.SparseNegativeBinomialGLM(
        50, B=4, L=10, seed=2,
        obs_kwargs=dict(r_init=5.0, resample_r=False, max_y=256),
        net_kwargs=dict(rho_init=0.1, learn_rho=False))
    jm.state = jm.state._replace(
        A=jnp.asarray(s["A"]), W=jnp.asarray(s["W"]), b=jnp.asarray(s["b"]),
        aux={"r": jnp.asarray(s["aux"]["r"])})
    Yj = jm.generate(100, keep=False)
    assert Yp.max() > 256 and Yj.max() > 256, (Yp.max(), Yj.max())
    res = acc.run("2_negative_binomial", True, "high", "cpu", true=port,
                  Y=Yp)
    assert res["truth_runaway"]["max_count"] > 256
    assert not acc.check_gates([res])[0]


RUNAWAY_SEEDS, RUNAWAY_T = range(40), 1000


def test_config2_prior_runs_away_no_more_often_than_jax():
    """Config 2's prior (the truth model's settings) draws supercritical
    truths in both packages: over seeds 0..39, the share of truths whose
    counts pass max_y within 1000 bins is no higher in the port than in
    the JAX package (one-sided two-proportion z below 3). So the port's
    truth at seed 2 running away is a draw, not a port fault."""
    import pyglm_tpu

    kw = dict(obs_kwargs=dict(r_init=5.0, resample_r=False, max_y=256),
              net_kwargs=dict(rho_init=0.1, learn_rho=False))
    port, jax_ = [], []
    j0 = None
    for s in RUNAWAY_SEEDS:
        Y = acc.SparseNegativeBinomialGLM(50, B=4, L=10, seed=s,
                                          device="cpu", **kw).generate(
            RUNAWAY_T, keep=False)
        port.append(Y.max() > 256)
        jm = pyglm_tpu.SparseNegativeBinomialGLM(50, B=4, L=10, seed=s, **kw)
        j0 = j0 or jm
        # One compiled generator for every seed: jm.generate(T) is
        # jm._generate(jm._next_key(), jm.state, jm.basis, T=T).
        Y, _ = j0._generate(jm._next_key(), jm.state, jm.basis, T=RUNAWAY_T)
        jax_.append(float(np.asarray(Y).max()) > 256)
    n = len(RUNAWAY_SEEDS)
    p_port, p_jax = np.mean(port), np.mean(jax_)
    p = (p_port + p_jax) / 2
    z = (p_port - p_jax) / np.sqrt(max(p * (1 - p), 1e-12) * 2 / n)
    print(f"config 2 prior runaways: port {sum(port)}/{n}, JAX "
          f"{sum(jax_)}/{n}, z {z:.2f}")
    assert 0 < sum(jax_) and z < 3.0, (sum(port), sum(jax_), z)


@pytest.mark.parametrize("stacked", [True, False])
def test_no_ensemble_chain_starts_from_a_model_of_its_seed(stacked):
    """An ensemble chain seeded s must not start from the prior draw of a
    model seeded s (the truth of acceptance config 5 has seed 5, and chain
    5 of the fit started from the truth's adjacency): the JAX package folds
    a salt into each chain's key. With no sweep before the first sample,
    chain c's first A is one sweep from its initial state; that state is
    the model's only if the streams collide."""
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    from pyglm_tpu_torch.models.ensemble import (
        chain_generators, ensemble_generators,
    )
    from pyglm_tpu_torch.models.sweep import init_state_from_prior

    kw = dict(observation="bernoulli", network="latent_distance",
              spike_and_slab=True, device="cpu", net_kwargs=dict(dim=2))
    truths = [NonlinearAutoregressiveModel(12, B=2, L=4, seed=s, **kw)
              for s in (1, 2, 3)]
    m = NonlinearAutoregressiveModel(12, B=2, L=4, seed=0, **kw)
    inits = [init_state_from_prior(ensemble_generators(s, "cpu"),
                                   m.observation, m.network, 12, 2, True,
                                   "cpu") for s in (1, 2, 3)]
    for t, st in zip(truths, inits):
        assert not torch.equal(t.state.A, st.A)
        assert not torch.equal(t.state.net.L, st.net.L)
    # A model of seed s draws its prior from the unsalted streams.
    st = init_state_from_prior(chain_generators(1, "cpu"), m.observation,
                               m.network, 12, 2, True, "cpu")
    assert torch.equal(st.A, truths[0].state.A)
    # The fit takes the salted streams on both paths: from the truth's
    # data, no chain's first sample equals the truth's adjacency.
    m.add_data(truths[1].generate(300, keep=False))
    out = m.fit_ensemble(n_chains=3, n_samples=4, seeds=[1, 2, 3],
                         stacked=stacked)
    for c, t in enumerate(truths):
        assert not np.array_equal(out["A"][c, 0], t.A)
