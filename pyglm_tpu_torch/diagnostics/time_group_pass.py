"""Device time of kernel K2 (one spike-and-slab group pass) at the
flagship's shapes, for the package of a given checkout.

    python pyglm_tpu_torch/diagnostics/time_group_pass.py [ROOT]

ROOT (default: the checkout holding this file) is put first on sys.path, so
an older checkout's package can be timed on the same card in the same
command, e.g. in the order older, this, this, older. It builds that
package's kernels, then times ``ss_group_pass_cuda`` on group g = 3 of 25
(GB = 32, T = 1e5, N = 200; a middle group: scatter, gather and Gram) with
CUDA events around 20 calls, five times, and prints the times and their
median with the card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path


def main() -> None:
    root = (sys.argv[1] if len(sys.argv) > 1
            else str(Path(__file__).resolve().parents[2]))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_group_pass: needs a CUDA device")
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    from pyglm_tpu_torch.ops.ss_cuda import ss_group_pass_cuda
    _build.build(force=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, N, GB = 100_000, 200, 32
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(4, 10)).T.contiguous()
    xp, xg = Xt[2 * GB:3 * GB], Xt[3 * GB:4 * GB]
    omega = 0.05 + 0.2 * torch.rand((T, N), generator=gen, device="cuda")
    u = 0.5 * torch.randn((T, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")

    def run(reps=20):
        ss_group_pass_cuda(xp, xg, omega, u, dw)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            ss_group_pass_cuda(xp, xg, omega, u, dw)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    times = [run() for _ in range(5)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{root}: K2 ms per middle group {[round(t, 4) for t in times]}, "
          f"median {statistics.median(times):.4f} ({card})")


if __name__ == "__main__":
    main()
