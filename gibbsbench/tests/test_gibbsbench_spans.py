"""gibbsbench/spans.py's readings on a synthetic recording: the set-up
spans' union, the network update's share less its waits, waits a step,
and device-idle time named by the innermost span."""
import pytest

from gibbsbench import spans, spec
from gibbsbench.tests import tiny
from pyglm_tpu_torch.diagnostics.profiling import Recording

MS = 1_000_000


def _rec(rows, steps=()):
    """rows: (name, parent, step, start ms, end ms)."""
    rec = Recording()
    rec.spans = [[n, p, s, a * MS, b * MS] for n, p, s, a, b in rows]
    rec.steps = [dict(st) for st in steps]
    return rec


def test_setup_is_the_union_of_its_spans():
    rec = _rec([("init", -1, -1, 0, 100), ("add_data", -1, -1, 150, 300),
                ("build", 1, -1, 200, 250), ("other", -1, -1, 300, 900),
                ("build", -1, -1, 280, 400)])
    assert spans.setup_program_s(rec) == pytest.approx(0.35)


def test_network_share_leaves_out_the_waits_inside_it():
    # network 0..100 ms: a wait 10..30 directly in it, and one 40..50 in
    # its child hmc 30..80; the wait 120..130 lies outside it.
    rec = _rec([("stacked_sweep", -1, 0, 0, 200), ("network", 0, 0, 0, 100),
                ("wait.weight_stats", 1, 0, 10, 30), ("hmc", 1, 0, 30, 80),
                ("wait.x", 3, 0, 40, 50), ("wait.diag", 0, 0, 120, 130)],
               [{"name": "stacked_sweep", "span": 0, "waits": 3,
                 "launches": {}}])
    assert spans.network_share(rec, 200 * MS) == pytest.approx(35.0)
    assert spans.host_waits_per_sweep(rec) == 3


def test_idle_time_is_named_by_the_innermost_span():
    # Device busy 0..10 and 40..50 ms of a 0..60 stretch. Spans: the step
    # 0..55, its network 5..35 and the network's wait 20..30.
    rec = _rec([("resample_model", -1, 0, 0, 55), ("network", 0, 0, 5, 35),
                ("wait.weight_stats", 1, 0, 20, 30)],
               [{"name": "resample_model", "span": 0, "waits": 1,
                 "launches": {}}])
    dev = [("k", 0.0, 0.010), ("k", 0.040, 0.050)]
    out = spans.idle_spans(dev, rec, 0.0, 0.060)
    assert out["idle_s"] == pytest.approx(0.040)
    got = dict(out["top"])
    # 10..40 ms, sampled at 8 points 3.75 ms apart (11.875, 15.625, ...):
    # the network at 3 before its wait and 2 after, the wait at 2, the
    # step at 38.125; 50..60 at 8 points 1.25 ms apart: the step at the 4
    # before 55, no span at the rest.
    assert got["network/wait.weight_stats"] == pytest.approx(0.0075)
    assert got["network"] == pytest.approx(0.01875)
    assert got["resample_model"] == pytest.approx(0.00375 + 0.005)
    assert got["python"] == pytest.approx(0.005)
    assert out["named_share"] == pytest.approx(100 * (1 - 0.005 / 0.040))


@pytest.mark.parametrize("traffic", ["single", "stacked"])
def test_a_small_cell_on_the_cpu_gives_every_reading(traffic):
    name = tiny.WORKLOAD[traffic]
    out = spans.measure(tiny.bench_of(name), "tiny", 2 ** 31 + 11, 0.3,
                        "cpu", cfg=tiny.tiny_config(name, *tiny.SHAPES[name]),
                        traffic=dict(spec.traffic(traffic), trace_steps=3))
    assert out["setup_program_s"] > 0 and out["kernel_builds"] is None
    assert 0 < out["network_share"] < 100
    assert out["host_waits_per_sweep"] == {"single": 6,
                                           "stacked": 17}[traffic]
    paths = {p for p, _, _ in out["self_ms_per_step"]}
    assert {"network", "network/niw", "pg_draws", "weights"} <= paths
    # On the CPU the profiler's stretch holds no device operation, so the
    # whole stretch is idle and named by the spans.
    assert out["b_on"]["ops_per_step"] == 0
    assert out["idle_spans"]["named_share"] > 50
