"""Readings for the correctness limits: a cell's compared numbers over many
seeds, at the configuration's precision and at the lower-precision
control, in one process (set-up is paid once for the kernels' build).

    python3 -m gibbsbench.calibrate --workload flagship.high \
        --seeds 101,102,103 --precision high,default --seconds 5 \
        [--fault psi_bf16] [--out chiprun_out/calibrate.jsonl]

Each (precision, seed) runs the cell as ``gibbsbench.run`` does, at the
cell's own sizes and loop, with a window of ``--seconds``, with the fault
``--fault`` planted if one is named (faults.py), and prints one
JSON line: the numbers compared, whether they pass the cell's limits, and
the window's rate. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from gibbsbench import faults, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default=None,
                    help="comma-separated modes (default: the config's)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default=None, choices=faults.FAULTS,
                    help="plant a fault (faults.py) in every run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    precs = args.precision.split(",") if args.precision else [None]
    out = open(args.out, "a") if args.out else None
    try:
        for prec in precs:
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                with faults.plant(args.fault):
                    res = run.run_cell(bench, args.workload, seed,
                                       args.seconds, False, "cuda",
                                       precision=prec, t0=t0)
                line = json.dumps({
                    "workload": args.workload, "precision": prec,
                    "fault": args.fault,
                    "seed": seed, "correct": res["correct"],
                    "checks": {k: c["value"]
                               for k, c in res["checks"].items()},
                    "metrics": {k: m["value"]
                                for k, m in res["metrics"].items()},
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
