"""Evaluation metrics and convergence diagnostics (PyTorch counterpart of
``pyglm_tpu/utils/metrics.py``). Host-side numpy, like the JAX package's:
held-out predictive log-likelihood and bits per spike, link AUC, split-R-hat
and ESS."""
from __future__ import annotations

import numpy as np


def link_auc(edge_scores, A_true) -> float:
    """AUC of edge scores (e.g. the posterior mean of A) against a true
    adjacency, by ranks with midranks for ties."""
    s = np.asarray(edge_scores, float).ravel()
    t = np.asarray(A_true).ravel().astype(bool)
    pos, neg = s[t], s[~t]
    if len(pos) == 0 or len(neg) == 0:
        return 1.0
    vals = np.concatenate([pos, neg])
    order = np.argsort(vals, kind="mergesort")
    ranks = np.empty(len(vals))
    ranks[order] = np.arange(1, len(vals) + 1)
    sorted_vals = vals[order]
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1
        i = j + 1
    r_pos = ranks[: len(pos)]
    return float((r_pos.sum() - len(pos) * (len(pos) + 1) / 2)
                 / (len(pos) * len(neg)))


def predictive_log_likelihood(model, Y_test, n_samples: int = 20,
                              thin: int = 1):
    """Posterior-averaged predictive log-likelihood of held-out spikes.

    Continues the model's Gibbs chain for n_samples * thin sweeps,
    evaluating log p(Y_test | theta_s) every `thin` sweeps, and returns the
    log-mean-exp over the samples (the paper's protocol) and the per-sample
    values. The chain state advances as a side effect."""
    lls = []
    for _ in range(n_samples):
        for _ in range(thin):
            model.resample_model()
        lls.append(model.log_likelihood(Y_test))
    lls = np.asarray(lls)
    m = lls.max()
    return float(m + np.log(np.mean(np.exp(lls - m)))), lls


def split_rhat(chains):
    """Split-R-hat (Gelman-Rubin potential scale reduction) per scalar
    component of (C, S, ...) traces: C chains of S >= 4 post-burn-in
    samples. Returns an array of shape ``chains.shape[2:]``. A component
    constant within every half-chain gives 1 where the chains agree and
    +inf where they differ (e.g. an edge frozen at 1 in one chain and at 0
    in another)."""
    x = np.asarray(chains, np.float64)
    C, S = x.shape[:2]
    if C < 2 or S < 4:
        raise ValueError(f"split_rhat needs >= 2 chains of >= 4 samples, "
                         f"got {C} x {S}")
    half = S // 2
    x = np.concatenate([x[:, :half], x[:, half: 2 * half]], axis=0)
    mean_j = x.mean(axis=1)
    W = x.var(axis=1, ddof=1).mean(axis=0)
    B = half * mean_j.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    tiny = 1e-12 * max(1.0, float(np.max(np.abs(mean_j))) ** 2)
    return np.where(W > 0, rhat, np.where(B <= tiny, 1.0, np.inf))


def ess_per_chain(x) -> float:
    """Effective sample size of a (S,) scalar trace by the initial positive
    sequence estimator of the autocorrelation time (Geyer 1992)."""
    x = np.asarray(x, np.float64)
    n = x.size
    x = x - x.mean()
    var = np.mean(x * x)
    if var <= 0:
        return float(n)
    acf = np.correlate(x, x, mode="full")[n - 1:] / (var * n)
    tau, k = 1.0, 1
    while k + 1 < n:
        pair = acf[k] + acf[k + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
        k += 2
    return float(n / max(tau, 1.0))


def bits_per_spike(pll, Y_test, baseline_rate=None) -> float:
    """A predictive log-likelihood (nats) as bits per spike over a
    homogeneous Bernoulli baseline at `baseline_rate` (default: the mean of
    Y_test), the paper's normalised metric."""
    Y = np.asarray(Y_test)
    n_spikes = Y.sum()
    T, N = Y.shape
    rate = Y.mean() if baseline_rate is None else baseline_rate
    rate = min(max(rate, 1e-12), 1 - 1e-12)
    ll_base = Y.sum() * np.log(rate) + (T * N - Y.sum()) * np.log(1 - rate)
    return float((pll - ll_base) / max(n_spikes, 1) / np.log(2))
