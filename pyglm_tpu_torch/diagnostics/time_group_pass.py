"""Device time of kernel K2 (one spike-and-slab group pass) at the
flagship's shapes, for the package of a given checkout, whole, its Gram
kernel alone and its streaming half alone.

    python pyglm_tpu_torch/diagnostics/time_group_pass.py [ROOT]
        [--precision high|default|sr] [--cut PART]...

ROOT (default: the checkout holding this file) is put first on sys.path, so
an older checkout's package can be timed on the same card in the same
command, e.g. in the order older, this, this, older. It builds that
package's kernels, then times ``ss_group_pass_cuda`` on group g = 3 of 25
(GB = 32, T = 1e5, N = 200; a middle group: scatter, gather and Gram) at
``--precision`` ("high" by default; at "default" and "sr" omega holds bf16
values, as the fused loop gives it, and the bf16 omega stream is made once
beforehand where the package's K2 takes one): CUDA events around 20 calls,
five times, and the median; then each kernel's own device time per call
over 20 traced calls (torch.profiler), the Gram's named apart ("high" in
older checkouts ran the Gram and M0 on one mma.sync kernel, so their line
holds both) and the streaming half's: the streaming pass
(``stream_pass_kernel``: the scatter and M0 in one pass) or, in older
checkouts, the scatter and M0 kernels summed; at "high" also cuBLAS SGEMM
on the materialised Z (the library call), and the library sequence of the
streaming half (xp.T @ dw, u.addcmul_, xg @ u in fp32). Then a digest of u,
and one of [M0, Jgg, sum_t omega], after one call at g = 3 from the same u
(equal digests across checkouts: the same values bit for bit).
``--cut build`` drops the Z build from the main loop of
``csrc/gram_wgmma.cuh`` (the Gram body of ``--precision``: the bf16 and SR
body, or at "high" its TF32 mode), ``--cut products`` its wgmma products
(both: the copies alone), as ``time_group_gram.py`` does: the cut copy of
the package goes to ROOT/build/gram_cut_<mode>_<parts>/ and its results are
wrong by design, so only its time is read. Prints the wgmma kernels'
registers and spills and the card's name and power limit. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import inspect
import statistics
import subprocess
import sys
from pathlib import Path

from time_group_gram import _CUTS
from timing import cut_copy, device_ms, digest


def _resources(log: Path, precision: str) -> str:
    """Registers and spills of K2's kernels at `precision` in the nvcc
    log: the Gram's wgmma body and the streaming pass at GB = 32 (its
    middle-group mode, scatter and gather)."""
    gram = {"high": "tf32_kernel", "default": "wgmma_kernelILb0",
            "sr": "wgmma_kernelILb1"}[precision]
    om = "Ef" if precision == "high" else "Et"
    lines, out = log.read_text().splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                gram in line
                or f"stream_pass_kernelILi32{om}Lb1ELb1E" in line):
            name = line.split("'")[1]
            short = "stream_pass_kernel" if "stream_pass" in name else gram
            out.append(f"{short}: " + " | ".join(
                x.strip().replace("ptxas info    : ", "")
                for x in lines[i + 2:i + 4]))
    return "; ".join(out) or "no wgmma kernel"


def _is_gram(name: str, precision: str) -> bool:
    """Whether kernel `name` is K2's Gram at `precision`: the wgmma body,
    or (older checkouts) the mma.sync tile loop's instantiation of the
    mode; at "high" the wgmma TF32 body, or (older checkouts) the 3xTF32
    mma.sync tile loop, which also ran M0."""
    if precision == "high":
        return "tf32_kernel" in name or "gram_tc_kernel" in name
    mode = {"default": 1, "sr": 2}[precision]
    return "wgmma" in name or f"gram_tc_kernel<{mode}>" in name


def _is_stream(name: str) -> bool:
    """Whether kernel `name` is part of K2's streaming half: the streaming
    pass, or (older checkouts) the scatter or M0's mma.sync kernel."""
    return any(k in name for k in ("stream_pass_kernel", "scatter_kernel",
                                   "m0_tc_kernel"))


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
    mode = "high" if args.precision == "high" else "default"
    pkg_root = (cut_copy(root, f"gram_cut_{mode}", *_CUTS[mode], args.cut)
                if args.cut else root)
    sys.path.insert(0, str(pkg_root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_group_pass: needs a CUDA device")
    from pyglm_tpu_torch.ops import _build, ss_cuda
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    _build.build()
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
    u0 = u.clone()

    def call():
        ss_cuda.ss_group_pass_cuda(xp, xg, omega, u, dw, **kw)

    def run(fn, reps=20):
        fn()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    # The library sequence of the streaming half (fp32 GEMMs, TF32 off) on
    # a copy of u.
    torch.backends.cuda.matmul.allow_tf32 = False
    u_l = u.clone()
    lib_ms = run(lambda: xg @ u_l.addcmul_(omega, xp.T @ dw, value=-1.0))
    lib = (f"; library streaming half (xp.T @ dw, addcmul_, xg @ u) "
           f"{lib_ms:.4f} ms")
    del u_l
    if args.precision == "high":
        p, q = ss_cuda.pair_index(GB, "cuda")
        Z = xg[p] * xg[q]
        lib += (f"; cuBLAS SGEMM on the materialised Z "
                f"{run(lambda: torch.matmul(Z, omega), 10):.4f} ms")
        del Z
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    u1 = u0.clone()
    out = ss_cuda.ss_group_pass_cuda(xp, xg, omega, u1, dw, True, **kw)
    digests = f"u {digest(u1)}, [M0, Jgg, sum omega] {digest(*out)}"
    del u1, out
    times = [run(call) for _ in range(5)]
    kernels = device_ms(call, 20)
    gram = sum(v for k, v in kernels.items() if _is_gram(k, args.precision))
    m0_in_gram = any("gram_tc_kernel" in k for k in kernels)
    stream = sum(v for k, v in kernels.items() if _is_stream(k))
    fused = any("stream_pass_kernel" in k for k in kernels)
    label = f"{root} {args.precision}" + "".join(
        f" --cut {c}" for c in args.cut)
    print(f"{label}: K2 ms per middle group {[round(t, 4) for t in times]}, "
          f"median {statistics.median(times):.4f}; Gram kernel {gram:.4f} ms"
          f"{' (with M0)' if m0_in_gram else ''}; streaming half "
          f"{stream:.4f} ms ("
          f"{'the streaming pass' if fused else 'the scatter + M0'}"
          f"{'' if fused or not m0_in_gram else ', M0 in the Gram'})"
          f"{lib}; digests {digests} ({card})", flush=True)
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.4f} ms  {k[:100]}")
    print(f"  {_resources(_build.LOG_PATH, args.precision)}", flush=True)


if __name__ == "__main__":
    main()
