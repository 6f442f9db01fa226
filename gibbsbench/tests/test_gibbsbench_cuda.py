"""A cell end to end on the card, through the command the benchmark's
check runs: a short window, the result line read back."""
import json
import subprocess
import sys

import pytest

from gibbsbench.spec import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship.high", "config5.ens8.high"])
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "-m", "gibbsbench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"
    for name, m in out["metrics"].items():
        if name.endswith("roofline") or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
