"""Each work counter against a count by hand at a small shape."""
import pytest

from gibbsbench import peaks, spec

# N=16 neurons, B=4, G=8: Ng=2 groups of GB=32 rows, npair=528; T=1000;
# 2 chains (32 lanes).
S = dict(T=1000, N=16, B=4, group=8, lanes=32, precision="high",
         betas=None, loop_kind="fused")


def test_k1_bytes():
    assert spec.work_counter("k1")(S) == [(0.0, 8 * 1000 * 32)]
    assert spec.work_counter("k1")(dict(S, betas=[0.5, 1.0])) == []


def test_k4_bytes():
    s = dict(S, betas=[0.5, 1.0])
    assert spec.work_counter("k4")(s) == [(0.0, 8 * 1000 * 32 + 4 * 32)]
    assert spec.work_counter("k4")(S) == []


@pytest.mark.parametrize("prec,om", [("high", 4), ("default", 2),
                                     ("sr", 2)])
def test_k2_gram(prec, om):
    got = spec.work_counter("k2_gram")(dict(S, precision=prec))
    one = (2 * 1000 * 32 * 528, 4 * 32 * 1000 + om * 1000 * 32
           + 4 * 528 * 32)
    assert got == [one, one]
    assert spec.work_counter("k2_gram")(dict(S, loop_kind="staged")) == []


def test_k2_pass():
    got = spec.work_counter("k2_pass")(S)
    x, om, u, gbn = 4 * 32 * 1000, 4 * 1000 * 32, 4 * 1000 * 32, 4 * 32 * 32
    prod = 2 * 1000 * 32 * 32
    assert got == [(prod, x + om + u + gbn + 4 * 32),
                   (2 * prod, 2 * x + om + 2 * u + 2 * gbn),
                   (prod, x + om + 2 * u + gbn)]


def test_k6():
    s = dict(S, loop_kind="staged")
    got = spec.work_counter("k6")(s)
    assert got == [(2 * 1000 * 32 * 528 * 2,
                    4 * 2 * 32 * 1000 + 4 * 1000 * 32 + 4 * 2 * 528 * 32)]
    assert spec.work_counter("k6")(S) == []


def test_sweep_flops():
    (f, b), = spec.work_counter("sweep")(S)
    P = 16 * 4 + 1
    assert f == 2 * 1000 * 32 * P + 2 * 1000 * 32 * 528 * 2 \
        + 2 * 2 * 1000 * 32 * 32 * 2
    assert b == 0.0


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds([(989e12, 0.0)]) == pytest.approx(1.0)
    assert peaks.least_seconds([(1.0, 3.35e12), (989e12, 1.0)]) == \
        pytest.approx(2.0)
