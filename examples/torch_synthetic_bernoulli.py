"""Demo: generate -> fit -> evaluate a sparse Bernoulli network GLM with
pyglm_tpu_torch (the port of examples/synthetic_bernoulli.py).

Builds a ground-truth model, simulates spikes, fits a fresh model by Gibbs
sampling and compares the inferred network with the truth.

    python examples/torch_synthetic_bernoulli.py            # on the card
    python examples/torch_synthetic_bernoulli.py --device cpu --T 2000 \\
        --samples 5 --burnin 5 --out /tmp/figs
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import pyglm_tpu_torch as pt  # noqa: E402
from pyglm_tpu_torch.utils.metrics import link_auc  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--N", type=int, default=27)
    p.add_argument("--T", type=int, default=60_000)
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--out", default=None,
                   help="directory for the figure (none: no figure)")
    return p.parse_args(argv)


def main(args):
    N, B, L = args.N, 4, 10
    true = pt.SparseBernoulliGLM(
        N, B=B, L=L, seed=42, device=args.device,
        net_kwargs=dict(rho_init=0.15, learn_rho=False, mu_bias=-2.5,
                        sigma_bias=0.25, learn_weight_prior=False,
                        sigma_w=1.0))
    Y = true.generate(args.T, keep=False)
    print(f"generated {Y.shape} spikes, rate={Y.mean():.3f}, "
          f"true edges={int(true.A.sum())}")

    model = pt.SparseBernoulliGLM(N, B=B, L=L, seed=0, device=args.device)
    model.add_data(Y)
    samples = model.fit(n_samples=args.samples, n_burnin=args.burnin,
                        verbose=True)

    A_mean = samples["A"].mean(0)
    W_eff = (samples["A"][..., None] * samples["W"]).sum(-1).mean(0)
    mask = true.A.astype(bool)
    corr = np.corrcoef(W_eff[mask], true.W_effective[mask])[0, 1]
    print(f"link AUC = {link_auc(A_mean, true.A):.3f}; active-edge weight "
          f"corr = {corr:.3f}")
    print(f"final log-likelihood = {samples['lls'][-1]:.1f}")
    if args.out:
        figure(args.out, true, model, Y, samples, W_eff)


def figure(out_dir, true, model, Y, samples, W_eff):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figures")
        return
    fig, axes = plt.subplots(2, 2, figsize=(10, 9))
    vmax = float(np.abs(true.W_effective).max())
    im = axes[0, 0].imshow(true.W_effective, cmap="RdBu_r", vmin=-vmax,
                           vmax=vmax)
    axes[0, 0].set_title("true $\\sum_b A W$")
    axes[0, 1].imshow(W_eff, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
    axes[0, 1].set_title("posterior mean $\\sum_b A W$")
    fig.colorbar(im, ax=axes[0, :2], shrink=0.8, label="net synaptic weight")
    for ax in axes[0]:
        ax.set_xlabel("postsynaptic n")
        ax.set_ylabel("presynaptic j")
    # conditional mean rates on a window of the training data
    t0, t1 = 500, min(1000, Y.shape[0])
    rates_fit = model.means[0][t0:t1]
    true.add_data(Y)
    rates_true = true.means[0][t0:t1]
    for n in range(3):
        axes[1, 0].plot(np.arange(t0, t1), rates_true[:, n] + 0.5 * n, "k-",
                        lw=0.8, label="true" if n == 0 else None)
        axes[1, 0].plot(np.arange(t0, t1), rates_fit[:, n] + 0.5 * n, "r-",
                        lw=0.8, alpha=0.7,
                        label="inferred" if n == 0 else None)
    axes[1, 0].set_title("conditional mean rate, neurons 0..2 (offset)")
    axes[1, 0].set_xlabel("time bin")
    axes[1, 0].legend(loc="upper right")
    axes[1, 1].plot(samples["lls"])
    axes[1, 1].set_title("log-likelihood trace (post-burn-in samples)")
    axes[1, 1].set_xlabel("sample")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_synthetic_bernoulli.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
