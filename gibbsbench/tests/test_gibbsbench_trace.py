"""The trace's reductions on a synthetic trace of two streams, and the
readers built on them."""
import pytest

from gibbsbench import peaks, spec
from gibbsbench.run import Run
from gibbsbench.tracing import Trace, covered, idle_gaps, union

# Stream 1: a 0..1, c 3..4; stream 2: b 0.5..1.5 beside a. Host: a sync
# from 1.4 to 3.2, inside which an inner copy runs 2.0..2.6.
DEV = [("void gram_kernel<1>", 0.0, 1.0), ("pass_kernel", 0.5, 1.5),
       ("void gram_kernel<1>", 3.0, 4.0)]
HOST = [("aten::item", 1.4, 3.2), ("cudaMemcpyAsync", 2.0, 2.6)]


def trace():
    return Trace(DEV, 0.0, 5.0, steps=2,
                 idle=idle_gaps(DEV, HOST, 0.0, 5.0, samples=2))


def test_union_merges_overlaps():
    assert union([(3, 4), (0, 1), (0.5, 1.5)]) == [[0, 1.5], [3, 4]]
    assert covered([(0, 1), (0.5, 1.5), (3, 4)], 0.0, 5.0) == 2.5
    assert covered([(0, 1), (0.5, 1.5), (3, 4)], 1.0, 3.5) == 1.0


def test_busy_counts_overlapping_kernels_once():
    tr = trace()
    assert tr.busy_s == 2.5 and tr.window_s == 5.0
    assert tr.kernel_s(["gram_kernel"]) == 2.0
    assert tr.kernel_s(["pass_kernel", "gram"]) == 3.0


def test_gaps_are_named_by_the_innermost_host_op():
    # The idle stretch 1.5..3.0 is sampled at 1.875 (the sync) and 2.625
    # (past the copy: the sync again); 4.0..5.0 at 4.25 and 4.75.
    gaps = idle_gaps(DEV, HOST, 0.0, 5.0, samples=2)
    assert gaps == [("aten::item", 0.75), ("aten::item", 0.75),
                    ("python", 0.5), ("python", 0.5)]
    gaps = idle_gaps(DEV, HOST, 0.0, 5.0, samples=4)
    assert ("cudaMemcpyAsync", 0.375) in gaps
    b = trace().breakdown()
    assert b["device_ops"][0] == ["void gram_kernel<1>", 2.0]
    assert b["idle_gaps"] == [["aten::item", 1.5], ["python", 1.0]]


def _run(tr):
    shape = dict(spec.config("flagship_bernoulli"), lanes=200,
                 precision="high", betas=None, loop_kind="fused")
    return Run(shape, 1, 1.0, window_s=10.0, steps=400, trace=tr)


def test_idle_share_and_launch_count():
    run = _run(trace())
    assert spec.metric_reader("idle_share")(run) == pytest.approx(50.0)
    assert spec.metric_reader("launches_per_sweep")(run) == 1.5
    assert spec.metric_reader("idle_share")(_run(None)) is None


def test_roofline_is_least_time_over_measured_time():
    dev = [("void group_pass_tf32_kernel<...>", 0.0, 0.02)]
    run = _run(Trace(dev, 0.0, 1.0, steps=2))
    launches = spec.work_counter("k2_gram")(run.shape)
    want = 100.0 * 2 * peaks.least_seconds(launches) / 0.02
    assert spec.metric_reader("k2_gram_roofline")(run) == pytest.approx(want)
    # No kernel of that name in the trace: nothing to read.
    assert spec.metric_reader("k6_roofline")(run) is None


def test_sweep_mfu_and_rate():
    run = _run(None)
    (flops, _), = spec.work_counter("sweep")(run.shape)
    assert spec.metric_reader("sweep_mfu")(run) == pytest.approx(
        100.0 * flops * 400 / (10.0 * peaks.PEAK_FLOPS))
    assert spec.metric_reader("sweeps_per_s")(run) == 40.0


@pytest.mark.parametrize("metric,base", [
    ("stacked_sweeps_per_s", "sweeps_per_s"),
    ("idle_share_stacked", "idle_share"),
    ("sweep_mfu_stacked", "sweep_mfu"),
    ("launches_per_sweep_stacked", "launches_per_sweep"),
    ("k1_roofline_stacked", "k1_roofline")])
def test_stacked_cells_read_their_metrics_as_a_single_chain_does(metric,
                                                                  base):
    assert spec.metric_reader(metric) is spec.metric_reader(base)


def test_every_metric_has_a_reader_and_moves_a_metric_of_its_cells():
    bench = spec.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for cell in cells:
        e2e = {m["name"] for m in spec.metrics_of(bench, "end_to_end", cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_of(bench, "per_layer", cell)
        assert layer and all(m["moves"] in e2e for m in layer)
