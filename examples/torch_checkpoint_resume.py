"""Demo: exact chain checkpoint and resume with pyglm_tpu_torch (the port
of examples/checkpoint_resume.py).

The chain's state and its generators' states go into one file; a model
rebuilt with the same configuration and data and loaded from it continues
the same chain, sweep for sweep.

    python examples/torch_checkpoint_resume.py              # on the card
    python examples/torch_checkpoint_resume.py --device cpu --T 1000 \\
        --sweeps 3 --resumed 3 --out /tmp/figs
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import pyglm_tpu_torch as pt  # noqa: E402
from pyglm_tpu_torch.utils.checkpoint import load_state, save_state  # noqa


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--N", type=int, default=10)
    p.add_argument("--T", type=int, default=5000)
    p.add_argument("--sweeps", type=int, default=20,
                   help="sweeps before the checkpoint")
    p.add_argument("--resumed", type=int, default=15,
                   help="sweeps after it, on both chains")
    p.add_argument("--out", default=None,
                   help="directory for the figure and the checkpoint (none: "
                        "the checkpoint in a temporary directory, no "
                        "figure)")
    return p.parse_args(argv)


def main(args):
    model = pt.SparseBernoulliGLM(args.N, B=4, L=10, seed=0,
                                  device=args.device)
    Y = model.generate(args.T, keep=True)
    for _ in range(args.sweeps):
        model.resample_model()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(args.out or tmp, "torch_chain.npz")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
        save_state(path, model)
        print(f"saved chain state to {path}")
        # later, elsewhere: rebuild the same configuration and resume
        resumed = pt.SparseBernoulliGLM(args.N, B=4, L=10, seed=999,
                                        device=args.device)
        resumed.add_data(Y)
        load_state(path, resumed)

    lls1 = [model.resample_model()["log_likelihood"]
            for _ in range(args.resumed)]
    lls2 = [resumed.resample_model()["log_likelihood"]
            for _ in range(args.resumed)]
    print(f"continued: ll={lls1[0]:.3f}")
    print(f"resumed:   ll={lls2[0]:.3f}")
    if lls1 != lls2:
        raise SystemExit("the resumed chain diverged from the original")
    print("exact resume verified (identical trajectories)")
    print(f"final log-likelihood = {lls2[-1]:.1f}")
    if args.out:
        figure(args.out, lls1, lls2)


def figure(out_dir, lls1, lls2):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figure")
        return
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(np.arange(len(lls1)), lls1, "k-", lw=2, label="original chain")
    ax.plot(np.arange(len(lls2)), lls2, "r--", lw=1.2,
            label="resumed from checkpoint")
    ax.set_title("exact resume: the same generator states, the same chain")
    ax.set_xlabel("sweep after checkpoint")
    ax.set_ylabel("log-likelihood")
    ax.legend()
    path = os.path.join(out_dir, "torch_checkpoint_resume.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(parse())
