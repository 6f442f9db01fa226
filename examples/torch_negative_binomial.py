"""Demo: negative-binomial counts with PG augmentation and CRT-based
dispersion learning, N=50, with pyglm_tpu_torch (the port of
examples/negative_binomial.py).

Generates counts from a ground-truth sparse NB GLM with a fixed dispersion
r = 5, then fits a fresh model that learns r per neuron (the collapsed
count-table CRT and a conjugate Gamma update) beside the network.

    python examples/torch_negative_binomial.py              # on the card
    python examples/torch_negative_binomial.py --device cpu --N 8 \\
        --T 2000 --burnin 3 --keep 3
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import pyglm_tpu_torch as pt  # noqa: E402
from pyglm_tpu_torch.utils.metrics import link_auc  # noqa: E402

R_TRUE = 5.0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--N", type=int, default=50)
    p.add_argument("--T", type=int, default=20_000)
    p.add_argument("--burnin", type=int, default=150)
    p.add_argument("--keep", type=int, default=150)
    p.add_argument("--out", default=None,
                   help="directory for the figure (none: no figure)")
    return p.parse_args(argv)


def main(args):
    N = args.N
    # NB's exp-mean link feeds back on itself: the weight scale shrinks
    # with N to keep the autoregressive dynamics stable.
    true = pt.SparseNegativeBinomialGLM(
        N, B=4, L=10, seed=7, device=args.device,
        obs_kwargs=dict(r_init=R_TRUE, resample_r=False, max_y=128),
        net_kwargs=dict(rho_init=0.05, learn_rho=False, sigma_w=0.001,
                        mu_bias=-2.5))
    Y = true.generate(args.T, keep=False)
    print(f"counts: mean={Y.mean():.2f}, max={Y.max():.0f}")

    model = pt.SparseNegativeBinomialGLM(
        N, B=4, L=10, seed=0, device=args.device,
        obs_kwargs=dict(max_y=int(Y.max()) + 1, a_r=5.0, b_r=1.0))
    model.add_data(Y)

    r_draws, lls = [], []
    A_mean, W_mean = np.zeros((N, N)), np.zeros((N, N))
    for it in range(args.burnin + args.keep):
        d = model.resample_model()
        if it % 25 == 0:
            r = model.state.aux["r"].cpu().numpy()
            print(f"iter {it}: ll={d['log_likelihood']:.0f} "
                  f"edges={d['n_edges']:.0f} r=[{r.min():.2f},{r.max():.2f}]")
        if it >= args.burnin:
            lls.append(d["log_likelihood"])
            r_draws.append(model.state.aux["r"].cpu().numpy())
            A_mean += model.A / args.keep
            W_mean += model.W_effective / args.keep
    r_draws = np.stack(r_draws)                       # (keep, N)
    print(f"link AUC = {link_auc(A_mean, true.A):.3f}; posterior r: "
          f"mean={r_draws.mean():.2f} (true {R_TRUE})")
    print(f"final log-likelihood = {lls[-1]:.1f}")
    if args.out:
        figure(args.out, true, W_mean, r_draws, lls)


def figure(out_dir, true, W_mean, r_draws, lls):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figures")
        return
    N = W_mean.shape[0]
    fig, axes = plt.subplots(2, 2, figsize=(10, 9))
    vmax = float(np.abs(true.W_effective).max())
    im = axes[0, 0].imshow(true.W_effective, cmap="RdBu_r", vmin=-vmax,
                           vmax=vmax)
    axes[0, 0].set_title("true $\\sum_b A W$")
    axes[0, 1].imshow(W_mean, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
    axes[0, 1].set_title("posterior mean $\\sum_b A W$")
    fig.colorbar(im, ax=axes[0, :2], shrink=0.8, label="net synaptic weight")
    for ax in axes[0]:
        ax.set_xlabel("postsynaptic n")
        ax.set_ylabel("presynaptic j")
    r_mean, r_sd = r_draws.mean(0), r_draws.std(0)
    order = np.argsort(r_mean)
    axes[1, 0].errorbar(np.arange(N), r_mean[order], yerr=2 * r_sd[order],
                        fmt="o", ms=3, lw=0.8, capsize=2,
                        label="posterior mean $\\pm 2$ sd")
    axes[1, 0].axhline(R_TRUE, color="k", ls="--", lw=1,
                       label=f"true $r = {R_TRUE:g}$")
    axes[1, 0].set_title("per-neuron dispersion recovery (CRT + gamma)")
    axes[1, 0].set_xlabel("neuron (sorted by posterior mean)")
    axes[1, 0].set_ylabel("$r_n$")
    axes[1, 0].legend(loc="upper left")
    axes[1, 1].plot(lls)
    axes[1, 1].set_title("log-likelihood trace (post-burn-in)")
    axes[1, 1].set_xlabel("sample")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_negative_binomial.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
