"""Device time of kernel K2 (one spike-and-slab group pass) at the
flagship's shapes, for the package of a given checkout, whole and its
Gram kernel alone.

    python pyglm_tpu_torch/diagnostics/time_group_pass.py [ROOT]
        [--precision high|default|sr] [--cut PART]...

ROOT (default: the checkout holding this file) is put first on sys.path, so
an older checkout's package can be timed on the same card in the same
command, e.g. in the order older, this, this, older. It builds that
package's kernels, then times ``ss_group_pass_cuda`` on group g = 3 of 25
(GB = 32, T = 1e5, N = 200; a middle group: scatter, gather and Gram) at
``--precision`` ("high" by default; at "default" and "sr" omega holds
bf16 values, as the fused loop gives it, and the bf16 omega stream is made
once beforehand where the package's K2 takes one): CUDA events around 20
calls, five times, and the median; then each kernel's own device time per
call over 20 traced calls (torch.profiler), the Gram's named apart ("high"
runs the Gram and M0 on one kernel, so its line holds both). ``--cut
build`` drops the Z build from the main loop of ``csrc/gram_wgmma.cuh``
(the bf16 and SR Gram body), ``--cut products`` its wgmma products, as
``time_group_gram.py`` does: the cut copy of the package goes to
ROOT/build/gram_cut_default_<parts>/ and its results are wrong by design,
so only its time is read. Prints the wgmma kernels' registers and spills and the
card's name and power limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess
import sys
from pathlib import Path

from time_group_gram import _CUTS
from timing import cut_copy, device_ms


def _wgmma_resources(log: Path) -> str:
    """Registers and spills of each wgmma kernel in the nvcc log."""
    lines, out = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "wgmma_kernel" in line:
            name = line.split("'")[1]
            out.append(f"{name}: " + " | ".join(
                x.strip() for x in lines[i + 2:i + 4]))
    return "; ".join(out) or "no wgmma kernel"


def _is_gram(name: str, precision: str) -> bool:
    """Whether kernel `name` is K2's Gram at `precision`: the wgmma body,
    or (older checkouts) the mma.sync tile loop's instantiation of the
    mode; at "high" the 3xTF32 tile loop, which also runs M0."""
    if precision == "high":
        return "gram_tc_kernel" in name
    mode = {"default": 1, "sr": 2}[precision]
    return "wgmma" in name or f"gram_tc_kernel<{mode}>" in name


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--precision", default="high",
                    choices=["high", "default", "sr"])
    ap.add_argument("--cut", action="append", default=[],
                    choices=sorted(_CUTS["default"][1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    pkg_root = (cut_copy(root, "gram_cut_default", *_CUTS["default"],
                         args.cut) if args.cut else root)
    sys.path.insert(0, str(pkg_root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_group_pass: needs a CUDA device")
    from pyglm_tpu_torch.ops import _build, ss_cuda
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    _build.build(force=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, N, GB = 100_000, 200, 32
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(4, 10)).T.contiguous()
    xp, xg = Xt[2 * GB:3 * GB], Xt[3 * GB:4 * GB]
    omega = 0.05 + 0.2 * torch.rand((T, N), generator=gen, device="cuda")
    u = 0.5 * torch.randn((T, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    kw = dict(precision=args.precision)
    if args.precision != "high":
        omega = ss_cuda.to_bf16(omega)
        if "om16" in inspect.signature(ss_cuda.ss_group_pass_cuda).parameters:
            kw["om16"] = ss_cuda.omega_bf16_stream(omega)
    if args.precision == "sr":
        kw["sr_seed"] = (5, 6)

    def call():
        ss_cuda.ss_group_pass_cuda(xp, xg, omega, u, dw, **kw)

    def run(reps=20):
        call()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            call()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    times = [run() for _ in range(5)]
    kernels = device_ms(call, 20)
    gram = sum(v for k, v in kernels.items() if _is_gram(k, args.precision))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    label = f"{root} {args.precision}" + "".join(
        f" --cut {c}" for c in args.cut)
    print(f"{label}: K2 ms per middle group {[round(t, 4) for t in times]}, "
          f"median {statistics.median(times):.4f}; Gram kernel "
          f"{gram:.4f} ms{' (with M0)' if args.precision == 'high' else ''}"
          f" ({card})", flush=True)
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.4f} ms  {k[:100]}")
    print(f"  {_wgmma_resources(_build.LOG_PATH)}", flush=True)


if __name__ == "__main__":
    main()
