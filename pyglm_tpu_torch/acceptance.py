"""Acceptance runner of the port: the five configs of the JAX package's
``benchmarks/acceptance.py``, end to end on the card.

For each config a ground-truth model (the port's own, at the JAX script's
seed) simulates T + T/10 bins; a fresh model (seed 0) fits the first T by
Gibbs and is scored on recovery: link AUC of the posterior edge marginals,
the correlation of the posterior mean of W_effective with the truth's on
the true edges, and the held-out predictive log-likelihood gap per bin
against the truth. The gates are the JAX script's regression floors
(``THRESHOLDS``, a copy), so a miss means a conditional or a kernel went
wrong, not Monte Carlo noise.

  1_bernoulli_dense     dense Bernoulli GLM (BernoulliGLM), N=27, T=60k,
                        500 + 150 sweeps (no AUC: every edge is present)
  2_negative_binomial   NB, N=50, T=20k, 1200 + 300 sweeps
  3_spike_slab          Bernoulli spike-and-slab, N=100, T=40k, 500 + 150
  4_sbm                 spike-and-slab under the SBM prior (K=5), N=100,
                        T=40k, 500 + 150
  5_latent_distance     latent-distance prior, N=500, T=20k, the pooled
                        posterior mean of 8 lane-stacked chains
                        (fit_ensemble collect="mean"), 1200 + 1200 each;
                        also each chain's own AUC and their spread, R-hat of
                        the log-likelihood, and chain-sweeps per second

Run: python -m pyglm_tpu_torch.acceptance [--quick] [--only SUBSTR]
         [--precision high|default|sr] [--out PATH] [--device cuda|cpu]
It writes acceptance_report_torch.json (acceptance_report_torch_<mode>.json
at another precision, acceptance_report_torch_partial.json with --only),
with the card's name and power limit, and exits 1 if a gate fails (full
runs only: --quick chains are too short to judge).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pyglm_tpu_torch.models.glm import (
    BernoulliGLM, NonlinearAutoregressiveModel, SparseBernoulliGLM,
    SparseNegativeBinomialGLM,
)
from pyglm_tpu_torch.utils.metrics import link_auc
from pyglm_tpu_torch.utils.utils import require_device

# A copy of the JAX script's floors: the measured values of its round-1/2
# runs less a Monte Carlo margin.
THRESHOLDS = {
    "1_bernoulli_dense": {
        "weight_corr": (">=", 0.75), "pred_ll_gap_per_bin": ("<=", 0.002)},
    "2_negative_binomial": {
        "link_auc": (">=", 0.86), "weight_corr": (">=", 0.85),
        "pred_ll_gap_per_bin": ("<=", 0.003)},
    "3_spike_slab": {
        "link_auc": (">=", 0.93), "weight_corr": (">=", 0.93),
        "pred_ll_gap_per_bin": ("<=", 0.004)},
    "4_sbm": {
        "link_auc": (">=", 0.93), "weight_corr": (">=", 0.93),
        "pred_ll_gap_per_bin": ("<=", 0.004)},
    "5_latent_distance": {
        "link_auc": (">=", 0.86), "weight_corr": (">=", 0.60),
        "pred_ll_gap_per_bin": ("<=", 0.040)},
}
CONFIGS = ("1_bernoulli_dense", "2_negative_binomial", "3_spike_slab",
           "4_sbm", "5_latent_distance")
# The SBM configs' block count.
K4 = 5


def check_gates(results):
    """Evaluate per-config thresholds. Returns (passed, failures)."""
    failures = []
    for res in results:
        for prefix, gates in THRESHOLDS.items():
            if not res["config"].startswith(prefix):
                continue
            for metric, (op, bound) in gates.items():
                if metric not in res:
                    failures.append(f"{res['config']}: metric {metric} missing")
                    continue
                v = res[metric]
                ok = v >= bound if op == ">=" else v <= bound
                if not ok:
                    failures.append(
                        f"{res['config']}: {metric}={v:.4f} violates "
                        f"{op} {bound}")
    return (not failures), failures


def card_info(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def lengths(name: str, quick: bool):
    """(T_train, n_burn, n_avg, n_chains) of a config; T_test = T/10."""
    if name == "1_bernoulli_dense":
        return (5_000, 10, 5, 1) if quick else (60_000, 500, 150, 1)
    if name == "2_negative_binomial":
        return (4_000, 10, 5, 1) if quick else (20_000, 1200, 300, 1)
    if name in ("3_spike_slab", "4_sbm"):
        return (5_000, 10, 5, 1) if quick else (40_000, 500, 150, 1)
    if name == "5_latent_distance":
        return (4_000, 10, 5, 4) if quick else (20_000, 1200, 1200, 8)
    raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")


def make_truth(name: str, device):
    """The config's ground-truth model, at the JAX script's seed."""
    if name == "1_bernoulli_dense":
        return BernoulliGLM(27, B=4, L=10, seed=1, device=device,
                            net_kwargs=dict(sigma_w=0.05, mu_bias=-2.5,
                                            learn_weight_prior=False))
    if name == "2_negative_binomial":
        return SparseNegativeBinomialGLM(
            50, B=4, L=10, seed=2, device=device,
            obs_kwargs=dict(r_init=5.0, resample_r=False, max_y=256),
            net_kwargs=dict(rho_init=0.1, learn_rho=False))
    if name == "3_spike_slab":
        return SparseBernoulliGLM(
            100, B=4, L=10, seed=3, device=device, net_kwargs=dict(
                rho_init=0.08, learn_rho=False, mu_bias=-2.5,
                sigma_bias=0.2, learn_weight_prior=False, sigma_w=1.5))
    if name == "4_sbm":
        return NonlinearAutoregressiveModel(
            100, B=4, L=10, observation="bernoulli", network="sbm",
            spike_and_slab=True, seed=4, device=device,
            net_kwargs=dict(K=K4, rho_init=0.1, mu_bias=-2.5))
    if name == "5_latent_distance":
        return NonlinearAutoregressiveModel(
            500, B=4, L=10, observation="bernoulli",
            network="latent_distance", spike_and_slab=True, seed=5,
            device=device, net_kwargs=dict(dim=2, mu_bias=-3.0))
    raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")


def make_model(name: str, precision: str, device):
    """The config's fitted model (seed 0) at `precision`."""
    if name == "1_bernoulli_dense":
        return BernoulliGLM(27, B=4, L=10, seed=0, precision=precision,
                            device=device)
    if name == "2_negative_binomial":
        return SparseNegativeBinomialGLM(
            50, B=4, L=10, seed=0, precision=precision, device=device,
            obs_kwargs=dict(max_y=256))
    if name == "3_spike_slab":
        return SparseBernoulliGLM(100, B=4, L=10, seed=0,
                                  precision=precision, device=device)
    if name == "4_sbm":
        return NonlinearAutoregressiveModel(
            100, B=4, L=10, observation="bernoulli", network="sbm",
            spike_and_slab=True, seed=0, precision=precision, device=device,
            net_kwargs=dict(K=K4))
    if name == "5_latent_distance":
        return NonlinearAutoregressiveModel(
            500, B=4, L=10, observation="bernoulli",
            network="latent_distance", spike_and_slab=True, seed=0,
            precision=precision, device=device, net_kwargs=dict(dim=2))
    raise ValueError(f"unknown config {name!r}: one of {CONFIGS}")


def simulate(true, T_total: int):
    """(Y (T_total, N) numpy, seconds) from the truth's generator."""
    t0 = time.perf_counter()
    Y = true.generate(T_total, keep=False)
    return Y, time.perf_counter() - t0


def _score(model, true, A_mean, Weff_mean, Y_test):
    out = {}
    if true.A.min() < 1:     # sparse truth: the AUC is meaningful
        out["link_auc"] = float(link_auc(A_mean, true.A))
    mask = true.A.astype(bool)
    if mask.sum() > 2:
        out["weight_corr"] = float(np.corrcoef(
            Weff_mean[mask], true.W_effective[mask])[0, 1])
    out["pred_ll_model"] = float(model.log_likelihood(Y_test))
    out["pred_ll_truth"] = float(true.log_likelihood(Y_test))
    out["pred_ll_gap_per_bin"] = float(
        (out["pred_ll_truth"] - out["pred_ll_model"]) / Y_test.size)
    return out


def run_config(name, true, model, Y, T_train, n_burn, n_avg):
    """Fit one config by single-chain Gibbs: n_burn sweeps, then n_avg
    sweeps whose A and W_effective accumulate on the device.
    sweeps_per_sec is the burn-in's host clock after its first sweep, up to
    a synchronisation."""
    Y_train, Y_test = Y[:T_train], Y[T_train:]
    model.add_data(Y_train)
    dev = model.device
    model.resample_model()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_burn - 1):
        model.resample_model()
    _sync(dev)
    sweep_s = (time.perf_counter() - t0) / max(n_burn - 1, 1)
    accA = torch.zeros((model.N, model.N), device=dev)
    accW = torch.zeros((model.N, model.N), device=dev)
    for _ in range(n_avg):
        model.resample_model()
        accA += model.state.A
        accW += (model.state.A[:, :, None] * model.state.W).sum(-1)
    res = {"config": name, "N": true.N, "T": T_train,
           "precision": model.precision,
           "rate": float(Y_train.mean()),
           "sweeps": [n_burn, n_avg],
           "sweeps_per_sec": 1.0 / sweep_s}
    res.update(_score(model, true, (accA / n_avg).cpu().numpy(),
                      (accW / n_avg).cpu().numpy(), Y_test))
    return res


def run_config5_ensemble(name, true, model, Y, T_train, n_burn, n_avg,
                         n_chains):
    """Fit config 5 by the pooled posterior mean of `n_chains`
    prior-initialised chains run as one lane-stacked sweep
    (fit_ensemble collect="mean"). The predictive LL is that of chain 0's
    final state, a posterior draw. Also records each chain's own link AUC
    and their spread, R-hat of the chains' log-likelihoods, and the
    chain-sweeps per second of the whole fit (host clock)."""
    Y_train, Y_test = Y[:T_train], Y[T_train:]
    model.add_data(Y_train)
    t0 = time.perf_counter()
    ens = model.fit_ensemble(n_chains=n_chains, n_samples=n_avg,
                             n_burnin=n_burn, collect="mean")
    _sync(model.device)
    el = time.perf_counter() - t0
    model.state = ens["final_states"][0]
    chain_auc = [float(link_auc(a, true.A)) for a in ens["A_mean"]]
    res = {"config": name, "N": true.N, "T": T_train,
           "precision": model.precision,
           "rate": float(Y_train.mean()),
           "estimator": f"pooled-ensemble C={n_chains} "
                        f"({n_burn}+{n_avg} sweeps/chain)",
           "rhat_ll": float(ens["rhat_ll"]),
           "chain_link_auc": chain_auc,
           "chain_link_auc_min": min(chain_auc),
           "chain_link_auc_max": max(chain_auc),
           "chain_link_auc_std": float(np.std(chain_auc)),
           "stacked_sweeps_per_sec": (n_burn + n_avg) / el,
           "chain_sweeps_per_sec": n_chains * (n_burn + n_avg) / el,
           "seconds": el}
    res.update(_score(model, true, ens["A_mean_pooled"],
                      ens["Weff_mean_pooled"], Y_test))
    return res


def run(name: str, quick: bool, precision: str, device, true=None,
        Y=None, sweeps=None) -> dict:
    """One config end to end; `true` and `Y` may be passed to fit the same
    simulated data at several precisions, and `sweeps` = (n_burn, n_avg)
    cuts the chains (a smoke run)."""
    T, n_burn, n_avg, C = lengths(name, quick)
    if sweeps is not None:
        n_burn, n_avg = sweeps
    gen_s = None
    if true is None:
        true = make_truth(name, device)
    if Y is None:
        Y, gen_s = simulate(true, T + T // 10)
    model = make_model(name, precision, device)
    max_y = getattr(model.observation, "max_y", None)
    if max_y is not None and Y.max() > max_y:
        # A supercritical truth: the exp-link autoregression ran away (the
        # generator caps the rate at 1e6), so the data hold counts the
        # fitted family cannot represent and recovery cannot be scored.
        # The config is not fit and its gates fail (metrics missing).
        over = np.flatnonzero(Y.max(axis=1) > max_y)
        return {"config": name, "N": true.N, "T": T,
                "precision": precision, "generate_s": gen_s,
                "truth_runaway": {
                    "max_count": float(Y.max()), "max_y": max_y,
                    "first_bin_over_max_y": int(over[0]),
                    "bins_over_max_y": int(over.size),
                    "truth_bias_max": float(true.bias.max()),
                    "truth_W_effective_max": float(true.W_effective.max())}}
    if name == "5_latent_distance":
        res = run_config5_ensemble(f"{name}_ensemble", true, model, Y, T,
                                   n_burn, n_avg, C)
    else:
        res = run_config(name, true, model, Y, T, n_burn, n_avg)
    res["generate_s"] = gen_s
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pyglm_tpu_torch.acceptance",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small T / few sweeps (a smoke run; not gated)")
    ap.add_argument("--out", default=None, help="report path")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="run only the configs whose name contains SUBSTR")
    ap.add_argument("--precision", default="high",
                    choices=("high", "default", "sr"),
                    help="the fitted models' precision (the truths generate "
                         "at 'high'); the same gates apply")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.out is None:
        suffix = "" if args.precision == "high" else f"_{args.precision}"
        args.out = (f"acceptance_report_torch{suffix}"
                    f"{'_partial' if args.only else ''}.json")
    device = require_device(args.device)
    names = [n for n in CONFIGS if args.only is None or args.only in n]
    if not names:
        print(f"no config matches --only {args.only!r}; nothing ran")
        return 2
    card = card_info(device)
    print(card)
    results = []
    for name in names:
        res = run(name, args.quick, args.precision, device)
        print(json.dumps(res), flush=True)
        results.append(res)
    passed, failures = check_gates(results)
    report = {"quick": args.quick, "precision": args.precision,
              "card": card, "results": results,
              "threshold_semantics": (
                  "regression floors of benchmarks/acceptance.py: its "
                  "measured "
                  "round-1/2 values less a Monte Carlo margin"),
              "thresholds": {k: {m: list(g) for m, g in v.items()}
                             for k, v in THRESHOLDS.items()},
              "gate": {"evaluated": not args.quick, "passed": passed,
                       "failures": failures}}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    if args.quick:
        print("gate: skipped (--quick chains are too short to judge)")
        return 0
    if passed:
        print("gate: PASS")
        return 0
    print("gate: FAIL")
    for f_ in failures:
        print("  " + f_)
    return 1


if __name__ == "__main__":
    sys.exit(main())
