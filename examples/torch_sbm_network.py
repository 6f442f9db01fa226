"""Demo: a stochastic-block-model network prior with its block labels
resampled, N=100, K=5, with pyglm_tpu_torch (the port of
examples/sbm_network.py).

    python examples/torch_sbm_network.py                    # on the card
    python examples/torch_sbm_network.py --device cpu --N 10 --T 2000 \\
        --sweeps 6 --burnin 3
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
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--K", type=int, default=5)
    p.add_argument("--T", type=int, default=20_000)
    p.add_argument("--sweeps", type=int, default=150)
    p.add_argument("--burnin", type=int, default=50)
    p.add_argument("--out", default=None,
                   help="directory for the figure (none: no figure)")
    return p.parse_args(argv)


def main(args):
    N, K = args.N, args.K
    true = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="sbm",
        spike_and_slab=True, seed=3, device=args.device,
        net_kwargs=dict(K=K, rho_init=0.15, mu_bias=-2.5))
    Y = true.generate(args.T, keep=False)

    model = pt.NonlinearAutoregressiveModel(
        N, B=4, L=10, observation="bernoulli", network="sbm",
        spike_and_slab=True, seed=0, device=args.device,
        net_kwargs=dict(K=K))
    model.add_data(Y)
    A_mean, n_avg = np.zeros((N, N)), 0
    for it in range(args.sweeps):
        d = model.resample_model()
        if it >= args.burnin:
            A_mean += model.A
            n_avg += 1
        if it % 10 == 0:
            c = model.state.net.c.cpu().numpy()
            print(f"iter {it}: ll={d['log_likelihood']:.0f} "
                  f"blocks={np.bincount(c, minlength=K)}")
    A_mean /= max(n_avg, 1)
    print(f"link AUC = {link_auc(A_mean, true.A):.3f}")
    print(f"final log-likelihood = {d['log_likelihood']:.1f}")
    if args.out:
        figure(args.out, true, model, A_mean)


def figure(out_dir, true, model, A_mean):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figure")
        return
    # rows and columns sorted by the block labels, so the SBM's community
    # structure shows
    order_true = np.argsort(true.state.net.c.cpu().numpy())
    order_fit = np.argsort(model.state.net.c.cpu().numpy())
    fig, axes = plt.subplots(1, 3, figsize=(13, 4.2))
    axes[0].imshow(true.A[np.ix_(order_true, order_true)], cmap="Greys")
    axes[0].set_title("true A (sorted by true blocks)")
    axes[1].imshow(A_mean[np.ix_(order_true, order_true)], cmap="Greys")
    axes[1].set_title("posterior mean A (same order)")
    axes[2].imshow(A_mean[np.ix_(order_fit, order_fit)], cmap="Greys")
    axes[2].set_title("posterior mean A (sorted by inferred blocks)")
    for ax in axes:
        ax.set_xlabel("postsynaptic n")
    axes[0].set_ylabel("presynaptic j")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_sbm_network.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
