"""Device time of kernel K6's "default" body (the bf16 group Gram) or its
"highest" body (the fp32 FMA group Gram) at acceptance config 5's shapes or
the flagship's, for the package of a given checkout, whole or with parts of
its main loop cut out.

    python pyglm_tpu_torch/diagnostics/time_group_gram.py [ROOT]
        [--precision default|high|highest] [--shape config5|flagship]
        [--cut PART]... [--splits N,N,...]

ROOT (default: the checkout holding this file) is put first on sys.path, so
older checkouts' packages can be timed on the same card in one command, in
turns (older, this, this, older). ``--cut build`` drops the Z build from
the body's main loop (``csrc/gram_wgmma.cuh`` at "default",
``csrc/group_gram.cu``'s fp32 body at "highest"), ``--cut products`` its
products, ``--cut lds`` (fp32 body) one of the four shared loads per step
of its products (the second omega float4, read as the first); the cut
copy of the package goes to ROOT/build/gram_cut_<parts>/ and its results
are wrong by design, so only its time is read: the time the remaining
parts take. It builds the package's kernels (and prints the Gram
kernels' registers and spills), checks the whole body against its
plain version, for bit-repeatability and against a float64 Gram of group
0, prints a digest of its output (equal digests: equal outputs, bit for
bit, e.g. across checkouts), then times ``group_gram_blocks_cuda`` with
CUDA events around 5 calls, three times, and prints the times, their
median and the rate with the card's name and power limit. At "highest" it
also times cuBLAS SGEMM on the materialised Z of every group (the library
call). Shapes: config 5, Xt (2001, 20000) and omega (20000, 4000), G = 10,
B = 4 (50 groups of 40 rows); the flagship, Xt (801, 100000) and omega
(100000, 200), G = 8, B = 4 (25 groups of 32 rows), the staged loop's call
at precision "highest". ``--splits 1,2,3`` (fp32 body, this checkout)
then times the body with T forced into each listed number of ranges, in
turns, each checked against the plain version. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# The statement of the main loop each cut replaces, per body: the file and
# (old, new) in it.
_CUTS = {
    "default": ("gram_wgmma.cuh", {
        "build": ("    if (s + 1 < nst) build_z(s + 1);\n", ""),
        "products": ("    for (int kk = 0; kk < kKS / 16; ++kk) "
                     "mma(acc, desc_a(a, kk), desc_b(b, kk));\n", ""),
    }),
    "highest": ("group_gram.cu", {
        "build": ("    if (s + 1 < s_end) fp32_build_z(s + 1);\n", ""),
        "products": ("      fp32_products(acc, as + (s & 1) * kFS * RT + "
                     "8 * ty,\n                    bs + (s & 1) * kFS * NT "
                     "+ 4 * tx);\n", ""),
        "lds": ("    const float4 b1 =\n"
                "        *reinterpret_cast<const float4*>(b + k * 8 * kNX + "
                "4 * kNX);\n", "    const float4 b1 = b0;\n"),
    }),
}
_SHAPES = {  # T, N, B, G, lanes, spike rate
    "config5": (20_000, 500, 4, 10, 4000, 0.05),
    "flagship": (100_000, 200, 4, 8, 200, 0.05),
}


def _cut_copy(root: Path, precision: str, parts: list[str]) -> Path:
    dst = root / "build" / f"gram_cut_{precision}_{'_'.join(parts)}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "pyglm_tpu_torch", dst / "pyglm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    fname, cuts = _CUTS[precision]
    path = dst / "pyglm_tpu_torch" / "csrc" / fname
    src = path.read_text()
    for part in parts:
        old, new = cuts.get(part, ("", ""))
        if not old or old not in src:
            raise SystemExit(f"time_group_gram: --cut {part} does not apply "
                             f"to {path}")
        src = src.replace(old, new)
    path.write_text(src)
    return dst


def _kernel_resources(log: Path, match: str) -> str:
    lines = log.read_text().splitlines()
    found = [" | ".join(x.strip() for x in lines[i + 2:i + 4])
             for i, line in enumerate(lines)
             if "Compiling entry function" in line and match in line]
    return "; ".join(found) or f"no {match} kernel"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--precision", default="default",
                    choices=("default", "high", "highest"))
    ap.add_argument("--shape", default="config5", choices=sorted(_SHAPES))
    ap.add_argument("--cut", action="append", default=[],
                    choices=("build", "products", "lds"))
    ap.add_argument("--splits", default=[],
                    type=lambda v: [int(n) for n in v.split(",")])
    args = ap.parse_args()
    prec = args.precision
    if args.cut and prec not in _CUTS:
        raise SystemExit(f"time_group_gram: no cuts at precision {prec!r}")
    if args.splits and (prec != "highest" or args.cut):
        raise SystemExit("time_group_gram: --splits times the uncut fp32 "
                         "body (--precision highest)")
    root = Path(args.root).resolve()
    pkg_root = _cut_copy(root, prec, args.cut) if args.cut else root
    sys.path.insert(0, str(pkg_root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_group_gram: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    from pyglm_tpu_torch.ops.gram_cuda import (group_gram_blocks_cuda,
                                               group_gram_blocks_plain)
    from pyglm_tpu_torch.ops.ss_cuda import pair_index, to_bf16
    _build.build(force=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, N, B, G, lanes, rate = _SHAPES[args.shape]
    GB, Ng = G * B, N // G
    Y = (torch.rand((T, N), generator=gen, device="cuda") < rate).float()
    Xt = design_matrix(Y, cosine_basis(B, 10)).T.contiguous()
    del Y
    omega = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen, device="cuda")
    rnd = to_bf16 if prec == "default" else (lambda x: x)
    p, q = pair_index(GB, "cuda")

    def gram():
        return group_gram_blocks_cuda(Xt, omega, B, G, precision=prec)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    checks = ""
    if not args.cut:
        k = gram()
        plain = group_gram_blocks_plain(Xt, omega, B, G, precision=prec)
        j64 = rnd(Xt[:GB][p] * Xt[:GB][q]).double() @ rnd(omega).double()
        digest = hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest()
        checks = (f"; sha256 {digest[:16]}, vs plain {rel(k, plain):.2e}, "
                  f"repeats {torch.equal(k, gram())}, vs float64 (group 0) "
                  f"{rel(k[0].double(), j64):.2e} (plain "
                  f"{rel(plain[0].double(), j64):.2e})")
        del k, plain, j64

    def run(fn, reps=5):
        fn()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    times = [run(gram) for _ in range(3)]
    med = statistics.median(times)
    if prec == "highest" and not args.cut:
        Z = Xt[:GB][p] * Xt[:GB][q]
        checks += (f"; cuBLAS SGEMM on the materialised Z x {Ng} groups "
                   f"{Ng * run(lambda: torch.matmul(Z, omega)):.3f} ms")
        del Z
    flops = 2.0 * Ng * (GB * (GB + 1) // 2) * lanes * T
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    label = f"{root} {args.shape}" + (f" --cut {' --cut '.join(args.cut)}"
                                      if args.cut else "")
    match = {"default": "wgmma_kernel", "high": "tc_kernel",
             "highest": "group_gram_kernel"}[prec]
    print(f"{label}: K6 {prec} ms {[round(t, 3) for t in times]}, median "
          f"{med:.3f} ({flops / med / 1e9:.1f} TFLOP/s); "
          f"{_kernel_resources(_build.LOG_PATH, match)}{checks} ({card})",
          flush=True)
    if args.splits:
        _time_splits(args.splits, label, card, gram, run, rel,
                     group_gram_blocks_plain(Xt, omega, B, G, precision=prec),
                     (GB, lanes, T, Ng))


def _time_splits(splits, label, card, gram, run, rel, plain, shape):
    """The fp32 body with T forced into each of `splits` ranges (the
    plan's function replaced for the call), timed in turns, three rounds;
    each checked once against the plain version."""
    from pyglm_tpu_torch.ops import gram_cuda
    plan = gram_cuda.fp32_split_plan
    chunks = -(-shape[2] // gram_cuda.FP32_FOLD)
    times, errs = {n: [] for n in splits}, {}
    try:
        for _ in range(3):
            for n in splits:
                per = -(-chunks // n)
                if -(-chunks // per) != n:
                    raise SystemExit(f"time_group_gram: T does not split "
                                     f"into {n} ranges of whole folds")
                gram_cuda.fp32_split_plan = (
                    lambda *a, n=n, per=per: (n, per * gram_cuda.FP32_FOLD))
                if n not in errs:
                    errs[n] = rel(gram(), plain)
                times[n].append(run(gram))
    finally:
        gram_cuda.fp32_split_plan = plan
    planned = plan(*shape)[0]
    for n in splits:
        print(f"{label}: K6 highest, T in {n} splits"
              f"{' (the plan)' if n == planned else ''}: ms "
              f"{[round(t, 3) for t in times[n]]}, median "
              f"{statistics.median(times[n]):.3f}, vs plain {errs[n]:.2e} "
              f"({card})", flush=True)


if __name__ == "__main__":
    main()
