"""Cells cut to a size a CPU test can run: the real configurations and
traffic mixes with few neurons and bins, and a benchmark of one cell."""
from __future__ import annotations

import copy

from gibbsbench import run, spec

CHECKS = ("psi_gap", "pg_z", "pg_z2", "pg_bad", "ss_a_lanes", "ss_w_gap",
          "net_gap", "swap_bad")
# The numbers of a sound run at these sizes are far inside these; the
# cells' own limits are in limits/<workload>.json.
LOOSE = {k: 1e9 for k in CHECKS}


def tiny_config(name: str, N: int, T: int, G: int) -> dict:
    cfg = copy.deepcopy(spec.config(name))
    cfg.update(N=N, T=T, group=G)
    if cfg["network"] == "latent_distance":
        cfg["prior"]["hmc_eps"] = 0.15 / N ** 0.5
    return cfg


# Config 5 at T < 384 runs the staged loop, as the cell's 4000 lanes do.
SHAPES = {"flagship_bernoulli": (16, 3000, 8),
          "config5_latent_distance": (20, 360, 10)}
WORKLOAD = {"single": "flagship_bernoulli", "stacked":
            "config5_latent_distance", "tempered": "config5_latent_distance"}


def bench_of(cfg_name: str) -> dict:
    bench = copy.deepcopy(spec.benchmark())
    bench["workloads"] = [{"name": "tiny", "config": cfg_name,
                           "traffic": "tiny", "chips": 1}]
    for sec in ("end_to_end", "per_layer"):
        for m in bench[sec]:
            m.pop("workloads", None)
    bench["per_layer"].append({"name": "k4_roofline", "unit": "%",
                               "moves": "stacked_sweeps_per_s"})
    return bench


def run_tiny(traffic_name: str, seed: int = 3, limits=None, trace=False,
             precision=None, seconds: float = 0.5) -> dict:
    cfg_name = WORKLOAD[traffic_name]
    cfg = tiny_config(cfg_name, *SHAPES[cfg_name])
    return run.run_cell(bench_of(cfg_name), "tiny", seed, seconds, trace,
                        "cpu", precision=precision,
                        limits=LOOSE if limits is None else limits,
                        cfg=cfg, traffic=spec.traffic(traffic_name))
