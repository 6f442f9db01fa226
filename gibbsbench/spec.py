"""Find a cell's files by name: its workload entry in BENCHMARK.json, the
configuration, the traffic mix, the correctness limits, and the metric
readers and work counters, each a file of its own under this folder."""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json: one of "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(HERE / "limits" / f"{workload_name}.json")


def metric_reader(name: str):
    """The reader of metric `name` (``metrics/<name>.py``): ``read(run) ->
    float | None``."""
    return importlib.import_module(f"gibbsbench.metrics.{name}").read


def work_counter(kernel: str):
    """The work counter of `kernel` (``work/<kernel>.py``): ``launches(s)
    -> [(flops, bytes), ...]`` for the launches of one step."""
    return importlib.import_module(f"gibbsbench.work.{kernel}").launches


def metrics_of(bench: dict, section: str, workload_name: str) -> list:
    """The metrics of `section` ("end_to_end" or "per_layer") that this
    cell reports: those that list it under "workloads", and those with no
    such key, where a per-layer one moves an end-to-end metric that the
    cell reports."""
    def listed(m):
        return workload_name in m.get("workloads", [workload_name])
    e2e = {m["name"] for m in bench["end_to_end"] if listed(m)}
    return [m for m in bench[section] if listed(m) and (
        section == "end_to_end" or "workloads" in m or m["moves"] in e2e)]
