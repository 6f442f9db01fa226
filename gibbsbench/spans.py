"""The program's stage spans in one cell, read beside the benchmark: a
tool of its own, whose numbers no result line carries.

    python3 -m gibbsbench.spans --workload <name> --seed <n> --seconds <s>

From the root of a checkout whose pyglm_tpu_torch has the span recorder
(``diagnostics/profiling.py``: ``recording``, ``span``, ``wait``). The
cell runs as ``gibbsbench.run`` runs it, with the recorder on through
set-up (the ``init``, ``add_data`` and ``build`` spans) and off in the
timed window; then, in stretches of the traffic's ``trace_steps`` steps:

(c) before any profiler, `rounds` stretches with the recorder off and
    as many with it on, in turns: their mean steps (what recording
    costs), the network update's share of the recorded stretches' wall
    time without the waits inside it (``network_share``), the ``wait``
    spans a step (``host_waits_per_sweep``; a stacked step counts once),
    and each span's self time a step;
(b) two stretches traced by torch.profiler on the device alone, the
    recorder off and then on: each stretch's device operations a step and
    idle share, and every device-idle stretch of the second named by the
    innermost program span open there ("python": none), on the one clock
    the spans and the device events share (``idle_spans``);
and one more recorded stretch after the profiler's (its step and
``network_share``: what a stretch placed there would read).

Prints one JSON line; the correctness check of ``gibbsbench.run`` is not
made.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from gibbsbench import run, spec  # noqa: E402

SETUP = ("init", "add_data", "build")


def _s(ns: int) -> float:
    return ns * 1e-9


def setup_program_s(rec) -> float:
    """Seconds of the union of the set-up spans (the model's construction,
    its data, the kernels' build or load)."""
    from gibbsbench.tracing import covered
    iv = [(_s(s), _s(e)) for name, _, _, s, e in rec.spans if name in SETUP]
    return covered(iv, min((a for a, _ in iv), default=0.0),
                   max((b for _, b in iv), default=0.0))


def network_share(rec, wall_ns: int) -> float:
    """100 x the ``network`` spans' time less the ``wait.*`` spans inside
    them, over `wall_ns`."""
    net = [i for i, sp in enumerate(rec.spans) if sp[0] == "network"]
    total = sum(rec.spans[i][4] - rec.spans[i][3] for i in net)
    for name, parent, _, s, e in rec.spans:
        if name.startswith("wait."):
            while parent >= 0 and rec.spans[parent][0] != "network":
                parent = rec.spans[parent][1]
            if parent >= 0:
                total -= e - s
    return 100.0 * total / wall_ns


def host_waits_per_sweep(rec) -> float:
    return sum(st["waits"] for st in rec.steps) / len(rec.steps)


def idle_spans(dev, rec, t0: float, t1: float, top: int = 12) -> dict:
    """The device-idle time of [t0, t1) (seconds on the spans' clock) by
    the innermost span open in it, tracing.idle_gaps with the spans in
    place of host operations: {"named_share": % of the idle time under a
    span, "idle_s": seconds, "top": [[span path, seconds], ...]}."""
    from gibbsbench.tracing import idle_gaps
    host = [(rec.path(i), _s(s), _s(e))
            for i, (_, _, _, s, e) in enumerate(rec.spans)]
    by = {}
    for name, sec in idle_gaps(dev, host, t0, t1):
        by[name] = by.get(name, 0.0) + sec
    idle = sum(by.values())
    return {"named_share": 100.0 * (1.0 - by.get("python", 0.0)
                                    / idle) if idle else None,
            "idle_s": idle,
            "top": [[k, v] for k, v in
                    sorted(by.items(), key=lambda kv: -kv[1])[:top]]}


def _device_stretch(step, n: int, sync, cuda: bool) -> dict:
    from torch.profiler import ProfilerActivity
    from gibbsbench.tracing import Trace, _stretch
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    (dev, _), t0, t1 = _stretch(step, n, [act], sync)
    tr = Trace(dev, t0, t1, n)
    ops = sum(1 for _, s, e in dev if e > t0 and s < t1)
    return {"dev": dev, "t0": t0, "t1": t1, "ops_per_step": ops / n,
            "idle_share": 100.0 * (1.0 - tr.busy_s / tr.window_s),
            "step_ms": 1e3 * tr.window_s / n}


def _recorded(step, n: int, sync):
    """(recording, wall ns) of n steps with the recorder on."""
    from pyglm_tpu_torch.diagnostics.profiling import recording
    with recording() as rec:
        sync()
        t0 = time.time_ns()
        for _ in range(n):
            step()
        sync()
        t1 = time.time_ns()
    return rec, t1 - t0


def _plain(step, n: int, sync) -> int:
    """Wall ns of n steps with the recorder off."""
    sync()
    t0 = time.time_ns()
    for _ in range(n):
        step()
    sync()
    return time.time_ns() - t0


def measure(bench: dict, name: str, seed: int, seconds: float,
            device="cuda", cfg: dict | None = None,
            traffic: dict | None = None, rounds: int = 3) -> dict:
    """The readings of one run of cell `name`; `cfg` and `traffic` replace
    the cell's files (tests at small shapes, on the CPU)."""
    import torch
    from gibbsbench import loops, simulate
    from pyglm_tpu_torch.diagnostics.profiling import recording
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    w = spec.workload(bench, name)
    cfg = spec.config(w["config"]) if cfg is None else cfg
    traffic = spec.traffic(w["traffic"]) if traffic is None else traffic
    n = traffic["trace_steps"]
    with recording() as setup:
        Y = simulate.make_inputs(cfg, seed, device)["Y"]
        system = loops.System(cfg, traffic, Y, seed, device)
        for _ in range(traffic["warmup_steps"]):
            system.step()
        sync()
    out = {"workload": name, "seed": seed,
           "card": run._card_line() if cuda else "cpu",
           "setup_s": time.perf_counter() - _T0,
           "setup_program_s": setup_program_s(setup),
           "kernel_builds": setup.counts.get("kernel_builds")}

    steps, tw = 0, time.perf_counter()
    while time.perf_counter() - tw < seconds:
        system.step()
        steps += 1
    sync()
    out["window_step_ms"] = 1e3 * (time.perf_counter() - tw) / steps

    # (c) before any profiler, in turns with as many steps unrecorded: the
    # recorder's cost, and the span readings.
    off_ns, on = [], []
    for _ in range(rounds):
        off_ns.append(_plain(system.step, n, sync))
        on.append(_recorded(system.step, n, sync))
    wall = sum(ns for _, ns in on)
    rec = on[0][0]
    out.update(
        off_step_ms=sum(off_ns) / (rounds * n) / 1e6,
        on_step_ms=wall / (rounds * n) / 1e6,
        network_share=sum(network_share(r, ns) * ns for r, ns in on) / wall,
        host_waits_per_sweep=host_waits_per_sweep(rec),
        launches_per_step={k: v / n for k, v in _launches(rec)},
        self_ms_per_step=[[p, own / n / 1e6, calls / n]
                          for p, calls, _, own in rec.table()])

    # (b) the device alone, the recorder off and then on.
    system.step()                         # absorbs the profiler's start
    sync()
    off = _device_stretch(system.step, n, sync, cuda)
    with recording() as rec_b:
        on_b = _device_stretch(system.step, n, sync, cuda)
    for key, st in (("off", off), ("on", on_b)):
        out[f"b_{key}"] = {k: st[k] for k in
                           ("ops_per_step", "idle_share", "step_ms")}
    out["idle_spans"] = idle_spans(on_b["dev"], rec_b, on_b["t0"],
                                   on_b["t1"])

    # (c) again, after the profiler's stretches.
    rec, ns = _recorded(system.step, n, sync)
    out.update(after_profiler_step_ms=ns / n / 1e6,
               after_profiler_network_share=network_share(rec, ns))
    return out


def _launches(rec) -> list:
    tot = {}
    for st in rec.steps:
        for k, v in st["launches"].items():
            tot[k] = tot.get(k, 0) + v
    return sorted(tot.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.set_environment()
    print(json.dumps(measure(spec.benchmark(), args.workload, args.seed,
                             args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
