"""Device time of kernel K1 (exact PG(1, c) draws, ``csrc/pg_devroye.cu``)
at the main paths' shapes, for the package of a given checkout, whole or
with statement groups of the kernel cut out.

    python pyglm_tpu_torch/diagnostics/time_pg.py [ROOT] [--cut PART]...

ROOT (default: the checkout holding this file) is put first on sys.path, so
older checkouts' packages can be timed on the same card in one command, in
turns (older, this, this, older). Each ``--cut`` removes one statement
group from the kernel: ``setup`` replaces the mixture weight by a constant,
``series`` accepts every proposal without the alternating-series test,
``exp_branch`` draws every proposal from the exponential tail (no truncated
inverse-Gaussian branch), ``levy`` takes the tilted Levy branch for every
inverse-Gaussian proposal (no Michael-Schucany-Haas). The cut copy of the
package goes to ROOT/build/pg_cut_<parts>/ and its draws follow another
law by design, so only its time is read. Uncut, it checks the draws at
the flagship shape against pg_mean and pg_var (the z of their sum, the
ratio of their spread) and prints a digest of them (equal digests: the
same draws, bit for bit). It then times ``pg_devroye_cuda`` on psi =
-2.5 + 2 randn at (100000, 200) (the flagship: T x N) and (20000, 4000)
(config 5: T x 8 chains x 500) with CUDA events around 10 calls, three
times, and prints the times, their median and the card's name and power
limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

# Each cut: the statement it replaces (old, new) in the kernel's source.
_CUTS = {
    "setup": ("        ratio_exp = mixture_weight(z);\n",
              "        ratio_exp = 0.3f;\n"),
    "series": ("  const float a1 = 3.0f * expf(w1);\n",
               "  const float a1 = 0.0f;\n"),
    "exp_branch": ("      tail = u0 <= ratio_exp;\n", "      tail = true;\n"),
    "levy": ("        levy = z * kT < 1.0f;\n", "        levy = true;\n"),
}
_SHAPES = {"flagship": (100_000, 200), "config5": (20_000, 4000)}


def _cut_copy(root: Path, parts: list[str]) -> Path:
    dst = root / "build" / f"pg_cut_{'_'.join(parts)}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "pyglm_tpu_torch", dst / "pyglm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src_path = dst / "pyglm_tpu_torch" / "csrc" / "pg_devroye.cu"
    src = src_path.read_text()
    for part in parts:
        old, new = _CUTS[part]
        if old not in src:
            raise SystemExit(f"time_pg: --cut {part} does not apply to "
                             f"{src_path}")
        src = src.replace(old, new)
    src_path.write_text(src)
    return dst


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
        raise SystemExit("time_pg: needs a CUDA device")
    from pyglm_tpu_torch.ops import _build
    from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
    from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var
    _build.build(force=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    label = f"{root}" + (f" --cut {' --cut '.join(args.cut)}"
                         if args.cut else "")
    for name, shape in _SHAPES.items():
        psi = -2.5 + 2.0 * torch.randn(shape, generator=gen, device="cuda")
        checks = ""
        if not args.cut and name == "flagship":
            om = pg_devroye_cuda(psi, 1, 0).double()
            m, v = pg_mean(1.0, psi).double(), pg_var(1.0, psi).double()
            z = float((om.sum() - m.sum()) / v.sum().sqrt())
            ratio = float(((om - m) ** 2).sum() / v.sum())
            digest = hashlib.sha256(om.cpu().numpy().tobytes()).hexdigest()
            checks = (f"; sum z {z:.3f}, spread ratio {ratio:.5f}, sha256 "
                      f"{digest[:16]}")

        def run(reps=10):
            pg_devroye_cuda(psi, 3, 0)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for i in range(reps):
                pg_devroye_cuda(psi, 3, i)
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / reps

        times = [run() for _ in range(3)]
        print(f"{label}: K1 {name} {shape} ms "
              f"{[round(t, 4) for t in times]}, median "
              f"{statistics.median(times):.4f}{checks} ({card})", flush=True)


if __name__ == "__main__":
    main()
