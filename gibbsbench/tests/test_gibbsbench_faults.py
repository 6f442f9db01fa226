"""The comparison that decides ``correct`` fails what it must, at a size a
CPU test can hold and under the cells' own limits: the lower-precision
control (the program at "default", one bf16 pass, for these "high"
cells), and the timed path broken underneath, once for each fault the
cells can have. The chip check is skipped: the runs are on the CPU."""
import pytest

from gibbsbench import faults, spec
from gibbsbench.tests.tiny import run_tiny

# The cells' limits, but for ss_w_gap, whose readings grow with T: at
# these sizes sound runs read 9e-6 (single, N=16, T=3000) and 3e-6
# (stacked, N=20, T=360), the "default" control 1.2e-3 and 1.6e-3.
LIMITS = {"single": dict(spec.limits("flagship.high"), ss_w_gap=1e-4),
          "stacked": dict(spec.limits("config5.ens8.high"), ss_w_gap=1e-4)}


@pytest.mark.parametrize("mix", ["single", "stacked"])
def test_sound_run_passes_the_cells_limits(mix):
    assert run_tiny(mix, limits=LIMITS[mix])["correct"] is True


@pytest.mark.parametrize("mix", ["single", "stacked"])
def test_lower_precision_control_fails(mix):
    res = run_tiny(mix, limits=LIMITS[mix], precision="default")
    assert res["correct"] is False
    assert res["checks"]["ss_w_gap"]["value"] > \
        res["checks"]["ss_w_gap"]["limit"]


@pytest.mark.parametrize("mix,fault", [
    (m, f) for m in ("single", "stacked") for f in faults.FAULTS])
def test_planted_fault_fails(mix, fault):
    with faults.plant(fault):
        res = run_tiny(mix, limits=LIMITS[mix])
    assert res["correct"] is False


@pytest.mark.parametrize("mix", ["single", "stacked"])
def test_wrong_spread_with_the_right_mean_fails_on_the_second_moment(mix):
    """Draws pulled 30% toward their mean pass the first-moment number and
    fail the second."""
    with faults.plant("pg_spread"):
        res = run_tiny(mix, limits=LIMITS[mix])
    checks = res["checks"]
    assert checks["pg_z"]["value"] <= checks["pg_z"]["limit"]
    assert checks["pg_z2"]["value"] > checks["pg_z2"]["limit"]


@pytest.mark.parametrize("mix", ["single", "stacked"])
def test_altered_weight_fails(mix, monkeypatch):
    """K3's answer altered where it is produced: one weight of the first
    group's first lane moved by 0.05."""
    from pyglm_tpu_torch.models import weights
    real = weights.ss_edge_scan

    def scan(jgg, m0, w, *a):
        dW, A = real(jgg, m0, w, *a)
        if w.data_ptr() == scan.first:
            w[0, 0] += 0.05
            dW[0, 0] += 0.05
        return dW, A
    scan.first = None
    real_loop = weights._fused_loop, weights._staged_loop

    def mark(loop):
        def run(generator, *args, **kw):
            w = args[5] if loop is real_loop[0] else args[3]
            scan.first = w.data_ptr()
            return loop(generator, *args, **kw)
        return run
    monkeypatch.setattr(weights, "ss_edge_scan", scan)
    monkeypatch.setattr(weights, "_fused_loop", mark(real_loop[0]))
    monkeypatch.setattr(weights, "_staged_loop", mark(real_loop[1]))
    res = run_tiny(mix, limits=LIMITS[mix])
    assert res["correct"] is False
    assert res["checks"]["ss_w_gap"]["value"] > 1e-3


def test_altered_network_move_fails(monkeypatch):
    """The Erdos-Renyi move's rho drawn 1% off."""
    from pyglm_tpu_torch.models import networks
    real = networks.sample_beta
    monkeypatch.setattr(networks, "sample_beta",
                        lambda a, b, g: 1.01 * real(a, b, g))
    res = run_tiny("single", limits=LIMITS["single"])
    assert res["correct"] is False
    assert res["checks"]["net_gap"]["value"] > 1e-3


def test_hmc_that_leaves_the_positions_fails(monkeypatch):
    """The latent-distance move returns its positions unchanged (with the
    acceptance rate of the real trajectories)."""
    from pyglm_tpu_torch.models.networks import LatentDistanceConfig
    real = LatentDistanceConfig._hmc

    def hmc(self, L, gamma, A, noise):
        _, _, rate = real(self, L, gamma, A, noise)
        return L, gamma, rate
    monkeypatch.setattr(LatentDistanceConfig, "_hmc", hmc)
    res = run_tiny("stacked", limits=LIMITS["stacked"])
    assert res["correct"] is False
    assert res["checks"]["net_gap"]["value"] > 1e-3


def test_tiny_cells_take_the_cells_loops():
    from pyglm_tpu_torch.models import weights
    run_tiny("single")
    assert weights.LAST_SS_PATH == "fused"
    run_tiny("stacked")
    assert weights.LAST_SS_PATH == "staged"
