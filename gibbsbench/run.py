"""Run one cell of the benchmark and print its result line.

    python3 -m gibbsbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Set-up
(imports, the kernels' build where it is not cached, the inputs made from
the seed, the model, the warm-up steps) is timed as ``setup_s``; then the
cell's loop runs step after step for ``--seconds``, and one device
synchronisation closes the window. With ``--trace 1`` a stretch of whole
steps then runs under torch.profiler for the per-layer metrics. Last,
further steps of the same loop are captured and judged against the
float64 reference (check.py), whose numbers and limits end the standard
error and the result line. The last line of standard output is the
result, as JSON.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

from gibbsbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pyglm_tpu")


@dataclass
class Run:
    """What the metric readers read. `shape`: the configuration with the
    step's lanes, precision, ladder and spike-and-slab loop."""
    shape: dict
    chains: int
    setup_s: float
    window_s: float = 0.0
    window_end: float = 0.0
    steps: int = 0
    step_starts: list = field(default_factory=list)
    trace: object = None


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_environment() -> None:
    """Before torch is imported: one host thread for the CPU's math
    libraries. The program's host work between kernels is small tensors
    on the CPU; with a pool of threads a sweep took longer and its time
    varied more run to run (PERF.md). The program builds its kernels with
    nvcc into ``build/pyglm_tpu_torch/`` inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, precision: str | None = None,
             t0: float = _T0, limits: dict | None = None,
             cfg: dict | None = None, traffic: dict | None = None) -> dict:
    """Set up, time, trace and check one cell; returns the result (the
    JSON line's fields). `precision` overrides the configuration's (the
    lower-precision control); `limits`, `cfg` and `traffic` replace the
    cell's files (tests at small shapes)."""
    import torch
    from gibbsbench import check, loops, simulate
    from gibbsbench.tracing import trace_steps
    w = spec.workload(bench, name)
    cfg = spec.config(w["config"]) if cfg is None else cfg
    traffic = spec.traffic(w["traffic"]) if traffic is None else traffic
    limits = spec.limits(name) if limits is None else limits

    inputs = simulate.make_inputs(cfg, seed, device)
    Y = inputs["Y"]
    _log(f"inputs: {cfg['T']} bins x {cfg['N']} neurons simulated in "
         f"{inputs['seconds']:.3f} s, {float(Y.mean()):.4f} spikes a bin")
    system = loops.System(cfg, traffic, Y, seed, device, precision)
    for _ in range(traffic["warmup_steps"]):
        system.step()
    _sync(device)
    from pyglm_tpu_torch.models import weights
    run = Run(dict(
        cfg, lanes=system.chains * cfg["N"], precision=system.precision,
        betas=system.betas, loop_kind=weights.LAST_SS_PATH),
        system.chains, time.perf_counter() - t0)

    tw = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - tw >= seconds:
            break
        run.step_starts.append(now)
        system.step()
    _sync(device)
    run.window_end = time.perf_counter()
    run.window_s, run.steps = run.window_end - tw, len(run.step_starts)
    _log(f"window: {run.steps} steps of {run.chains} chains in "
         f"{run.window_s:.3f} s")
    if trace:
        run.trace = trace_steps(system.step, traffic["trace_steps"],
                                traffic["trace_host_steps"])
    is_cuda = torch.device(device).type == "cuda"
    mem = torch.cuda.max_memory_allocated() if is_cuda else 0

    caps = [system.capture() for _ in range(traffic["check_steps"])]
    del system
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    from gibbsbench.reference.design import design
    X = design(Y, cfg["B"], cfg["L"])
    numbers = {}
    for cap in caps:
        for k, v in check.check_step(cfg, cap, Y, X).items():
            numbers[k] = max(numbers.get(k, v), v)
    del caps, X
    correct, rows = check.judge(numbers, limits)
    _log(f"check: {traffic['check_steps']} steps against the float64 "
         f"reference in {time.perf_counter() - tc:.3f} s")

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, section, name):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": int(mem)}
    result = {"correct": bool(correct),
              "attempted": run.steps * run.chains,
              "failed": 0 if correct else traffic["check_steps"] * run.chains,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def _card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(w["chips"]):
        _log(f"gibbsbench: needs {w['chips']} CUDA device(s), found {found}")
        return 2
    try:
        import pyglm_tpu_torch
    except ImportError as e:
        _log(f"gibbsbench: the program is not in this checkout ({e})")
        return 2
    if spec.ROOT not in Path(pyglm_tpu_torch.__file__).resolve().parents:
        _log(f"gibbsbench: pyglm_tpu_torch comes from "
             f"{pyglm_tpu_torch.__file__}, outside the checkout")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        _log(f"gibbsbench: modules {bad} were loaded; the port must run "
             f"without JAX or the JAX package")
        return 3
    _log(f"card: {_card_line()}")
    for k, c in result["checks"].items():
        _log(f"{k} {c['value']:.6g} limit {c['limit']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
