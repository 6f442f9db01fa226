"""Demo: multi-chain convergence diagnostics with fit_ensemble and
split-R-hat, with pyglm_tpu_torch (the port of
examples/convergence_diagnostics.py).

Several chains from overdispersed (prior) starts run as one lane-stacked
sweep; split-R-hat over every marginal and the ESS of each chain's
log-likelihood trace say whether they have converged.

    python examples/torch_convergence_diagnostics.py        # on the card
    python examples/torch_convergence_diagnostics.py --device cpu --N 8 \\
        --T 2000 --samples 6 --burnin 4
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import pyglm_tpu_torch as pt  # noqa: E402
from pyglm_tpu_torch.utils.metrics import ess_per_chain, link_auc  # noqa


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--N", type=int, default=20)
    p.add_argument("--T", type=int, default=20_000)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--samples", type=int, default=150)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--out", default=None,
                   help="directory for the figure (none: no figure)")
    return p.parse_args(argv)


def main(args):
    N, B, L = args.N, 4, 10
    true = pt.SparseBernoulliGLM(
        N, B=B, L=L, seed=7, device=args.device,
        net_kwargs=dict(rho_init=0.2, learn_rho=False, mu_bias=-2.5,
                        sigma_bias=0.25, learn_weight_prior=False,
                        sigma_w=1.0))
    Y = true.generate(args.T, keep=False)
    print(f"generated {Y.shape} spikes, rate={Y.mean():.3f}")

    model = pt.SparseBernoulliGLM(N, B=B, L=L, seed=0, device=args.device)
    model.add_data(Y)
    out = model.fit_ensemble(n_chains=args.chains, n_samples=args.samples,
                             n_burnin=args.burnin)

    print(f"split-R-hat  edges: max={np.nanmax(out['rhat_edge']):.3f} "
          f"(frac > 1.1: {(out['rhat_edge'] > 1.1).mean():.3f})")
    print(f"split-R-hat  bias:  max={np.nanmax(out['rhat_bias']):.3f}")
    print(f"split-R-hat  loglik: {out['rhat_ll']:.3f}")
    ess = [ess_per_chain(out["lls"][c]) for c in range(out["lls"].shape[0])]
    print(f"ESS(loglik) per chain: {np.round(ess, 1)} of "
          f"{out['lls'].shape[1]}")
    A_mean = out["A"].reshape(-1, N, N).mean(0)     # pooled over chains
    print(f"pooled link AUC vs truth: {link_auc(A_mean, true.A):.3f}")
    print(f"final log-likelihood per chain = "
          f"{[round(float(x), 1) for x in out['lls'][:, -1]]}")
    if args.out:
        figure(args.out, out, ess)


def figure(out_dir, out, ess):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figures")
        return
    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    for c in range(out["lls"].shape[0]):
        axes[0, 0].plot(out["lls"][c], lw=0.8, label=f"chain {c}")
    axes[0, 0].set_title("log-likelihood traces (prior-initialised chains)")
    axes[0, 0].set_xlabel("post-burn-in sample")
    axes[0, 0].legend(loc="lower right", fontsize=8)
    rh = out["rhat_edge"].ravel()
    axes[0, 1].hist(rh[np.isfinite(rh)], bins=40)
    axes[0, 1].axvline(1.1, color="r", ls="--", lw=1, label="1.1 threshold")
    axes[0, 1].set_title("split-$\\hat R$ over edge marginals $A_{jn}$")
    axes[0, 1].set_xlabel("$\\hat R$")
    axes[0, 1].legend()
    axes[1, 0].plot(np.sort(out["rhat_bias"]), "o-", ms=3)
    axes[1, 0].axhline(1.1, color="r", ls="--", lw=1)
    axes[1, 0].set_title("split-$\\hat R$ per bias (sorted)")
    axes[1, 0].set_xlabel("neuron (sorted)")
    axes[1, 0].set_ylabel("$\\hat R$")
    axes[1, 1].bar(np.arange(len(ess)), ess)
    axes[1, 1].axhline(out["lls"].shape[1], color="k", ls=":", lw=1,
                       label="chain length (iid bound)")
    axes[1, 1].set_title("ESS(loglik) per chain")
    axes[1, 1].set_xlabel("chain")
    axes[1, 1].legend()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_convergence_diagnostics.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
