"""Device time of kernel K6's "default" body (the bf16 group Gram) at
acceptance config 5's shapes, for the package of a given checkout, whole
or with parts of its main loop cut out.

    python pyglm_tpu_torch/diagnostics/time_group_gram.py [ROOT] [--cut PART]...

ROOT (default: the checkout holding this file) is put first on sys.path, so
older checkouts' packages can be timed on the same card in one command, in
turns (older, this, this, older). ``--cut build`` drops the Z build from
the main loop of ``csrc/gram_wgmma.cuh``, ``--cut products`` its wgmma
products; the cut copy of the package goes to ROOT/build/gram_cut_<parts>/
and its results are wrong by design, so only its time is read: the time
the remaining parts take. It builds the package's kernels (and prints the
wgmma kernel's registers and spills), checks the whole body against its
plain version, for bit-repeatability and against a float64 Gram of group
0, prints a digest of its output (equal digests: equal outputs, bit for
bit, e.g. across checkouts), then times
``group_gram_blocks_cuda(..., precision="default")`` on Xt
(2001, 20000) and omega (20000, 4000), G = 10, B = 4 (50 groups of 40
rows) with CUDA events around 5 calls, three times, and prints the times,
their median and the rate with the card's name and power limit. Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# The statements of the main loop each cut removes.
_CUTS = {
    "build": "    if (s + 1 < nst) build_z(s + 1);\n",
    "products": ("    for (int kk = 0; kk < kKS / 16; ++kk) "
                 "mma(acc, desc_a(a, kk), desc_b(b, kk));\n"),
}


def _cut_copy(root: Path, parts: list[str]) -> Path:
    dst = root / "build" / f"gram_cut_{'_'.join(parts)}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "pyglm_tpu_torch", dst / "pyglm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = dst / "pyglm_tpu_torch" / "csrc" / "gram_wgmma.cuh"
    src = header.read_text()
    for part in parts:
        if _CUTS[part] not in src:
            raise SystemExit(f"time_group_gram: --cut {part} does not apply "
                             f"to {header}")
        src = src.replace(_CUTS[part], "")
    header.write_text(src)
    return dst


def _kernel_resources(log: Path) -> str:
    lines = log.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "wgmma_kernel" in line:
            return " | ".join(x.strip() for x in lines[i + 2:i + 4])
    return "no wgmma kernel"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?",
                    default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--cut", action="append", default=[],
                    choices=sorted(_CUTS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    pkg_root = _cut_copy(root, args.cut) if args.cut else root
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
    T, N, B, G, lanes = 20_000, 500, 4, 10, 4000
    GB, Ng = G * B, N // G
    Y = (torch.rand((T, N), generator=gen, device="cuda") < 0.05).float()
    Xt = design_matrix(Y, cosine_basis(B, 10)).T.contiguous()
    del Y
    omega = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen, device="cuda")

    def gram():
        return group_gram_blocks_cuda(Xt, omega, B, G, precision="default")

    checks = ""
    if not args.cut:
        k = gram()
        plain = group_gram_blocks_plain(Xt, omega, B, G, precision="default")
        p, q = pair_index(GB, "cuda")
        j64 = to_bf16(Xt[:GB][p] * Xt[:GB][q]).double() @ to_bf16(
            omega).double()

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        digest = hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest()
        checks = (f"; sha256 {digest[:16]}, vs plain {rel(k, plain):.2e}, "
                  f"repeats {torch.equal(k, gram())}, vs float64 (group 0) "
                  f"{rel(k[0].double(), j64):.2e} (plain "
                  f"{rel(plain[0].double(), j64):.2e})")
        del k, plain, j64

    def run(reps=5):
        gram()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            gram()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / reps

    times = [run() for _ in range(3)]
    med = statistics.median(times)
    flops = 2.0 * Ng * (GB * (GB + 1) // 2) * lanes * T
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    label = f"{root}" + (f" --cut {' --cut '.join(args.cut)}"
                         if args.cut else "")
    print(f"{label}: K6 default ms {[round(t, 3) for t in times]}, median "
          f"{med:.3f} ({flops / med / 1e9:.1f} TFLOP/s); "
          f"{_kernel_resources(_build.LOG_PATH)}{checks} ({card})",
          flush=True)


if __name__ == "__main__":
    main()
