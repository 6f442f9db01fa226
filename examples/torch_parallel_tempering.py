"""Demo: parallel-tempered inference for a slow-mixing latent-distance GLM
with pyglm_tpu_torch (the port of examples/parallel_tempering.py).

fit_tempered runs a ladder of inverse temperatures as one lane-stacked
sweep with replica-exchange swaps; the cold (beta = 1) rung is the exact
sampler, and the swaps let its state hop between rungs. A plain chain at
the same number of kept samples runs beside it for comparison.

    python examples/torch_parallel_tempering.py             # on the card
    python examples/torch_parallel_tempering.py --device cpu --N 8 \\
        --T 2000 --samples 4 --burnin 2 --pilot 4 --rungs 3
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
    p.add_argument("--N", type=int, default=30)
    p.add_argument("--T", type=int, default=10_000)
    p.add_argument("--samples", type=int, default=400)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--rungs", type=int, default=8)
    p.add_argument("--pilot", type=int, default=200,
                   help="burn-in sweeps of the pilot that sets the ladder")
    p.add_argument("--out", default=None,
                   help="directory for the figure (none: no figure)")
    return p.parse_args(argv)


def main(args):
    N, B, L = args.N, 4, 10
    true = pt.NonlinearAutoregressiveModel(
        N, B=B, L=L, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=5, device=args.device,
        net_kwargs=dict(dim=2, mu_bias=-2.5))
    Y = true.generate(args.T, keep=False)
    print(f"generated {Y.shape} spikes, rate={Y.mean():.3f}")

    model = pt.NonlinearAutoregressiveModel(
        N, B=B, L=L, observation="bernoulli", network="latent_distance",
        spike_and_slab=True, seed=0, device=args.device,
        net_kwargs=dict(dim=2))
    model.add_data(Y)
    plain = model.fit_compiled(n_samples=args.samples, n_burnin=args.burnin)
    # an n-rung ladder sized from a pilot's measured sd(ll)
    out = model.fit_tempered(n_samples=args.samples, n_burnin=args.burnin,
                             n_rungs=args.rungs, pilot_sweeps=args.pilot)
    print("ladder betas:", np.round(out["betas"], 5))
    print("swap rate per rung:", np.round(out["swap_rate"], 3))
    for name, s in (("plain", plain), ("tempered cold rung", out)):
        print(f"{name:>20}: link AUC {link_auc(s['A'].mean(0), true.A):.3f}"
              f" over {s['A'].shape[0]} samples")
    print(f"final log-likelihood = {out['lls'][-1]:.1f} (cold rung), "
          f"{plain['lls'][-1]:.1f} (plain)")
    if args.out:
        figure(args.out, true.A, plain, out)


def figure(out_dir, A_true, plain, out):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figures")
        return
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
    axes[0].imshow(A_true, cmap="gray_r", interpolation="nearest")
    axes[0].set_title("true adjacency")
    axes[1].imshow(plain["A"].mean(0), cmap="gray_r",
                   interpolation="nearest", vmin=0, vmax=1)
    axes[1].set_title("plain chain P(edge)")
    axes[2].imshow(out["A"].mean(0), cmap="gray_r",
                   interpolation="nearest", vmin=0, vmax=1)
    axes[2].set_title("tempered cold rung P(edge)")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "torch_parallel_tempering.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
