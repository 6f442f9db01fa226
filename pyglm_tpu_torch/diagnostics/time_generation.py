"""Host-clock time of the forward generator (``models/sweep.py::
make_generator``, the per-bin loop that paces ``chip_smoke.py``'s Geweke
lanes and every ``generate``) for the package of a given checkout.

    python pyglm_tpu_torch/diagnostics/time_generation.py [ROOT]

ROOT (default: the checkout holding this file) is put first on sys.path, so
older checkouts' packages can be timed on the same card in one command, in
turns (older, this, this, older). A Bernoulli model under the ER prior of
``chip_smoke.py``'s Bernoulli Geweke lanes, its state drawn from the prior
at seed 0, generates T bins from a generator at seed 1, once to warm up and
then 5 times in each of three runs (``torch.cuda.synchronize`` around each
run), at the Geweke lanes' shape (N=8, B=4, L=10, T=384) and at the
flagship's width (N=200, T=2000). Prints the ms per T bins of each run,
their median, a digest of the first call's Y and psi (equal digests: the
same draws, bit for bit) and the card's name and power limit. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

from timing import digest

_SHAPES = {"geweke": (8, 384), "flagship": (200, 2000)}
B, L = 4, 10


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_generation: needs a CUDA device")
    from pyglm_tpu_torch.models.ensemble import chain_generators
    from pyglm_tpu_torch.models.networks import ErdosRenyiConfig
    from pyglm_tpu_torch.models.observations import Bernoulli
    from pyglm_tpu_torch.models.sweep import (
        init_state_from_prior, make_generator)
    from pyglm_tpu_torch.ops.basis import cosine_basis
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    basis = cosine_basis(B, L)
    for name, (n, t) in _SHAPES.items():
        net = ErdosRenyiConfig(N=n, B=B, learn_rho=False,
                               learn_weight_prior=False, rho_init=0.4,
                               sigma_w=0.25, mu_bias=-1.5, sigma_bias=0.3)
        st = init_state_from_prior(chain_generators(0, "cuda"), Bernoulli(),
                                   net, n, B, True, "cuda")
        gen = make_generator(Bernoulli(), n, B)
        g = torch.Generator(device="cuda").manual_seed(1)
        Y, psi = gen(g, st, basis, t)

        def run(reps=5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                gen(g, st, basis, t)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        times = [run() for _ in range(3)]
        med = statistics.median(times)
        print(f"{root}: generate {name} N={n} T={t} ms "
              f"{[round(x, 2) for x in times]}, median {med:.2f} "
              f"({med / t * 1e3:.0f} us a bin), sha256 {digest(Y, psi)}, "
              f"rate {float(Y.mean()):.4f} ({card})", flush=True)


if __name__ == "__main__":
    main()
