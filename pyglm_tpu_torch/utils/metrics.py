"""Evaluation metrics (the port's subset of ``pyglm_tpu/utils/metrics.py``).
Host-side numpy, like the JAX package's."""
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
