"""Chain-level posterior parity: the port's precision modes against each
other and against the f64 NumPy oracle (``reference/numpy_ref.py``), on the
data and priors of ``benchmarks/sr_parity.py``.

The protocol: N=8, B=4, L=10 (GB=32, so the fused spike-and-slab loop
runs), T=1500 bins from a seeded truth, 150 + 400 sweeps. Each pool is
PAR_C lane-stacked chains (``fit_ensemble``) on seeds of its own; each
chain contributes its posterior means of A, W_effective and the bias. Two
pools are held to each other by their max edge-marginal difference (within
``perm_band``) and by every edge's difference in standard errors of the two
pools' means; a pool is held to a pool of oracle chains at the tolerances
of ``tests/test_numpy_parity.py`` (``oracle_gates``).

Run as a script, it measures how those gates behave where nothing is
biased (needs a CUDA card):

    python -m pyglm_tpu_torch.diagnostics.parity [--high 8] [--default 2]
        [--sr 2] [--oracle 128] [--procs 7] [--out PATH]

It runs ``--high`` pools at "high" (seed bases 1, 101, 401, ...), the
other modes' pools, and ``--oracle`` oracle chains in ``--procs`` spawned
processes (one BLAS thread each), then prints one JSON object: every pair
of "high" pools against the chain-parity gates; every port pool against
every disjoint pool of ORC_C oracle chains; and the false-failure rates of
both gates over random disjoint draws of pools from all the "high" chains
and all the oracle chains. With ``--out PATH`` it also writes the readings
there and every chain's posterior means beside them (``PATH`` with
``.npz``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import multiprocessing as mp
import os
import subprocess
import time

import numpy as np

PAR_N, PAR_B, PAR_L, PAR_T, PAR_BURN, PAR_KEEP = 8, 4, 10, 1500, 150, 400
# Chains per pool. Edge (3, 0) is bimodal here: each chain's marginal sits
# near 0 or near 1, so at 16 chains two unbiased pools differed there by up
# to 0.32. At 64 the difference of two pools has half that spread.
PAR_C = 64
# The chain-parity band: the PAR_PERM_Q quantile of the max edge-marginal
# difference over PAR_PERM random splits of the two pools' chains (they are
# exchangeable without a bias), and never above PAR_BAND_CAP, the oracle
# protocol's own tolerance.
PAR_PERM, PAR_PERM_Q, PAR_BAND_CAP = 10_000, 0.999, 0.22
PAR_Z = 5.0
PAR_NET = dict(rho_init=0.35, learn_rho=False, mu_bias=-1.2, sigma_bias=0.4,
               learn_weight_prior=False, sigma_w=0.8)
# Oracle chains per pool, and tests/test_numpy_parity.py's tolerances.
ORC_C = 32
ORC_TOL = {"max_edge_marginal_diff": 0.22, "max_weight_mean_diff": 0.35,
           "max_bias_mean_diff": 0.25, "mean_edge_prob_diff": 0.06}
ORC_Z = 5.0
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def posterior_means(ref, Y, n_burn: int, n_keep: int):
    """n_burn + n_keep sweeps of a NumpyGLMReference on Y (T, N): the means
    over the kept sweeps of A, W_effective (A times W summed over the
    basis) and the bias."""
    Y = np.asarray(Y, np.float64)
    Xf = ref.design(Y)
    N = Y.shape[1]
    A = np.zeros((N, N)); W = np.zeros((N, N)); b = np.zeros(N)
    for it in range(n_burn + n_keep):
        ref.resample(Y, Xf)
        if it >= n_burn:
            A += ref.A / n_keep
            W += (ref.A[:, :, None] * ref.W).sum(-1) / n_keep
            b += ref.b / n_keep
    return A, W, b


def parity_data(device="cuda"):
    """The data of benchmarks/sr_parity.py: a SparseBernoulliGLM(PAR_N)
    truth (seed 123) generates PAR_T bins."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.ops.basis import cosine_basis
    return SparseBernoulliGLM(PAR_N, basis=cosine_basis(PAR_B, PAR_L),
                              seed=123, net_kwargs=PAR_NET,
                              device=device).generate(PAR_T, keep=False)


def parity_pool(Y, precision: str, s0: int, device="cuda"):
    """PAR_C lane-stacked chains at `precision` on seeds s0 .. s0+PAR_C-1:
    each chain's posterior means {"A", "W" (W_effective): (PAR_C, N, N),
    "b": (PAR_C, N)}, and the loop that ran."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.ops.basis import cosine_basis
    m = SparseBernoulliGLM(PAR_N, basis=cosine_basis(PAR_B, PAR_L), seed=0,
                           net_kwargs=PAR_NET, precision=precision,
                           device=device)
    m.add_data(Y)
    out = m.fit_ensemble(n_chains=PAR_C, n_burnin=PAR_BURN,
                         n_samples=PAR_KEEP, seeds=list(range(s0, s0 + PAR_C)))
    return ({"A": out["A"].mean(1), "W": out["W"].sum(-1).mean(1),
             "b": out["bias"].mean(1)}, weights.LAST_SS_PATH)


def perm_band(a, b, seed: int = 0) -> float:
    """The chain-parity band of two pools of chains a, b (C, N, N): the
    PAR_PERM_Q quantile of the max edge-marginal difference over PAR_PERM
    random splits of their chains into pools of the same sizes, capped at
    PAR_BAND_CAP."""
    x = np.concatenate([a, b]).reshape(len(a) + len(b), -1)
    rng = np.random.default_rng(seed)
    stats = []
    for _ in range(PAR_PERM // 1000):
        idx = np.argsort(rng.random((1000, len(x))), axis=1)
        stats.append(np.abs(x[idx[:, :len(a)]].mean(1)
                            - x[idx[:, len(a):]].mean(1)).max(1))
    return min(PAR_BAND_CAP,
               float(np.quantile(np.concatenate(stats), PAR_PERM_Q)))


def pool_compare(p1, p2, n_keep: int = PAR_KEEP) -> dict:
    """The oracle protocol's numbers for two pools of per-chain means
    {"A", "W": (C, N, N), "b": (C, N)}, and the max per-edge |z| of the
    edge marginals on the pools' combined standard error (from the spread
    of their chains, floored at one kept sweep of one chain of the smaller
    pool: edges that no chain ever flips)."""
    m1 = {k: v.mean(0) for k, v in p1.items()}
    m2 = {k: v.mean(0) for k, v in p2.items()}
    c1, c2 = p1["A"].shape[0], p2["A"].shape[0]
    d = np.abs(m1["A"] - m2["A"])
    se = np.sqrt(p1["A"].var(0, ddof=1) / c1 + p2["A"].var(0, ddof=1) / c2
                 + (1.0 / (min(c1, c2) * n_keep)) ** 2)
    return {"max_edge_marginal_diff": float(d.max()),
            "max_weight_mean_diff": float(np.abs(m1["W"] - m2["W"]).max()),
            "max_bias_mean_diff": float(np.abs(m1["b"] - m2["b"]).max()),
            "mean_edge_prob_diff": float(abs(m1["A"].mean()
                                             - m2["A"].mean())),
            "max_z": float((d / se).max())}


def oracle_gates(r: dict) -> bool:
    """pool_compare's numbers within the oracle protocol's tolerances and
    every edge within ORC_Z standard errors."""
    return (all(r[k] < tol for k, tol in ORC_TOL.items())
            and r["max_z"] < ORC_Z)


def parity_gates(p1, p2) -> tuple[bool, dict]:
    """The chain-parity gates of pool p1 against pool p2: the max
    edge-marginal difference within perm_band and every edge within PAR_Z
    standard errors. (verdict, numbers)."""
    r = pool_compare(p1, p2)
    r["band"] = perm_band(p1["A"], p2["A"])
    return (r["max_edge_marginal_diff"] <= r["band"]
            and r["max_z"] < PAR_Z), r


def oracle_chain(Y, seed: int):
    """One oracle chain of PAR_BURN + PAR_KEEP sweeps on Y at the protocol's
    priors: its posterior means of A, W_effective and the bias, and its
    seconds. The oracle's sigma_b is the bias prior's variance and the
    models' sigma_bias its standard deviation (sigma_w is a variance in
    both), so the oracle takes sigma_bias squared: the same posterior.
    (tests/test_numpy_parity.py passes 0.4 to both, which gives the oracle
    a bias prior 2.5 times as wide.)"""
    from pyglm_tpu_torch.ops.basis import cosine_basis
    from pyglm_tpu_torch.reference.numpy_ref import NumpyGLMReference
    ref = NumpyGLMReference(
        N=PAR_N, B=PAR_B,
        basis=np.asarray(cosine_basis(PAR_B, PAR_L), np.float64),
        rho=PAR_NET["rho_init"], mu_w=0.0, sigma_w=PAR_NET["sigma_w"],
        mu_b=PAR_NET["mu_bias"], sigma_b=PAR_NET["sigma_bias"] ** 2,
        seed=seed)
    t0 = time.perf_counter()
    A, W, b = posterior_means(ref, Y, PAR_BURN, PAR_KEEP)
    return A, W, b, time.perf_counter() - t0


def start_oracle(Y, seeds, processes: int):
    """Start oracle chains on `seeds` in a pool of `processes` spawned
    processes, each with one BLAS thread: (pool, pending result). Join the
    pool after the result, or terminate it."""
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update({k: "1" for k in _ONE_THREAD})
    try:
        pool = mp.get_context("spawn").Pool(processes)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    res = pool.starmap_async(oracle_chain,
                             [(np.asarray(Y), s) for s in seeds])
    pool.close()
    return pool, res


def stack_chains(res) -> dict:
    """oracle_chain results -> a pool {"A", "W", "b"} of per-chain means."""
    return {k: np.stack([r[i] for r in res]) for i, k in enumerate("AWb")}


def _subpool(pool, idx):
    return {k: v[idx] for k, v in pool.items()}


def null_study(n_high: int, n_default: int, n_sr: int, n_oracle: int,
               procs: int, draws: int = 2000):
    """The gates where no mode is biased (see the module docstring):
    (the port's pools, the oracle's pool of all its chains, the
    readings)."""
    Y = parity_data()
    bases = {"high": [1, 101] + [401 + 100 * i for i in range(n_high - 2)]}
    nxt = 401 + 100 * max(n_high - 2, 0)
    bases["default"] = [201] + [nxt + 100 * i for i in range(n_default - 1)]
    nxt += 100 * max(n_default - 1, 0)
    bases["sr"] = [301] + [nxt + 100 * i for i in range(n_sr - 1)]
    orc_pool, pending = start_oracle(Y, range(7, 7 + n_oracle), procs)
    try:
        t0 = time.perf_counter()
        pools = {f"{p}{s}": parity_pool(Y, p, s)[0]
                 for p, ss in bases.items() for s in ss}
        pool_s = time.perf_counter() - t0
        res = pending.get(timeout=3000)
        orc_pool.join()
    except BaseException:
        orc_pool.terminate()
        raise
    orc = stack_chains(res)
    highs = [f"high{s}" for s in bases["high"]]
    pairs = {}
    for a, b in itertools.combinations(highs, 2):
        ok, r = parity_gates(pools[a], pools[b])
        pairs[f"{a}-{b}"] = dict(r, ok=ok)
    orc_pools = [_subpool(orc, slice(i, i + ORC_C))
                 for i in range(0, n_oracle - ORC_C + 1, ORC_C)]
    vs_oracle = {}
    for k, p in pools.items():
        rs = [pool_compare(p, o) for o in orc_pools]
        vs_oracle[k] = {"ok": [oracle_gates(r) for r in rs],
                        "max_edge_marginal_diff": [
                            r["max_edge_marginal_diff"] for r in rs],
                        "max_weight_mean_diff": [
                            r["max_weight_mean_diff"] for r in rs],
                        "max_z": [r["max_z"] for r in rs]}
    # False-failure rates over random disjoint draws from all the chains.
    allh = {k: np.concatenate([pools[h][k] for h in highs]) for k in "AWb"}
    rng = np.random.default_rng(1)
    n_h = len(allh["A"])
    par_fail = {"over_cap": 0, "z": 0}
    orc_fail = {k: 0 for k in (*ORC_TOL, "max_z", "any")}
    for _ in range(draws):
        i = rng.permutation(n_h)
        p1, p2 = _subpool(allh, i[:PAR_C]), _subpool(allh, i[PAR_C:2 * PAR_C])
        r = pool_compare(p1, p2)
        par_fail["over_cap"] += r["max_edge_marginal_diff"] > PAR_BAND_CAP
        par_fail["z"] += r["max_z"] >= PAR_Z
        r = pool_compare(p1, _subpool(orc, rng.permutation(n_oracle)[:ORC_C]))
        for k, tol in ORC_TOL.items():
            orc_fail[k] += r[k] >= tol
        orc_fail["max_z"] += r["max_z"] >= ORC_Z
        orc_fail["any"] += not oracle_gates(r)
    return pools, orc, {
        "par_c": PAR_C, "orc_c": ORC_C, "pool_s": pool_s,
        "pool_s_each": pool_s / len(pools),
        "oracle_chain_s": [r[3] for r in res],
        "high_pairs": pairs,
        "high_pairs_failed": sum(not v["ok"] for v in pairs.values()),
        "n_high_pairs": len(pairs),
        "vs_high1": {k: parity_gates(pools[k], pools["high1"])[1]
                     for k in pools if k != "high1"},
        "vs_oracle": vs_oracle,
        "vs_oracle_failed": sum(not ok for v in vs_oracle.values()
                                for ok in v["ok"]),
        "n_vs_oracle": sum(len(v["ok"]) for v in vs_oracle.values()),
        "draws": draws,
        "parity_fail_rate": {k: v / draws for k, v in par_fail.items()},
        "oracle_fail_rate": {k: v / draws for k, v in orc_fail.items()},
    }


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--high", type=int, default=8)
    ap.add_argument("--default", type=int, default=2)
    ap.add_argument("--sr", type=int, default=2)
    ap.add_argument("--oracle", type=int, default=128)
    ap.add_argument("--procs", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("parity: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    pools, orc, out = null_study(a.high, a.default, a.sr, a.oracle, a.procs)
    out["card"] = card
    if a.out:
        with open(a.out, "w") as f:
            f.write(json.dumps(out) + "\n")
        np.savez(os.path.splitext(a.out)[0] + ".npz", **{
            f"{name}_{k}": v for name, p in (*pools.items(), ("oracle", orc))
            for k, v in p.items()})
    print(card)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("high_pairs", "vs_high1", "vs_oracle")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
