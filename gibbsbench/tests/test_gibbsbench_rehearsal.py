"""Each traffic mix rehearsed end to end at a tiny shape on the CPU, in a
fresh process: the run comes out correct, reads its per-layer metrics,
and loads no module whose top-level name is jax, jaxlib, flax or
pyglm_tpu; the reference and the comparison load nothing of the
program."""
import json
import subprocess
import sys

import pytest

from gibbsbench.spec import ROOT

REHEARSE = """
import json, sys
from gibbsbench.tests.tiny import run_tiny
from gibbsbench.run import forbidden_modules
r = run_tiny({mix!r}, trace=True)
print(json.dumps({{"correct": r["correct"], "metrics": r["metrics"],
                  "forbidden": forbidden_modules()}}))
"""


def _python(code: str) -> dict:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mix", ["single", "stacked", "tempered"])
def test_mix_rehearses_correct_and_without_jax(mix):
    out = _python(REHEARSE.format(mix=mix))
    assert out["correct"] is True
    assert out["forbidden"] == []
    assert "sweep_mfu" in out["metrics"] and "idle_share" in out["metrics"]
    if mix == "tempered":
        assert "k4_roofline" not in out["metrics"]     # no device trace


def test_reference_loads_nothing_of_the_program():
    out = _python(
        "import json, sys\n"
        "import gibbsbench.check, gibbsbench.reference.glm\n"
        "import gibbsbench.reference.networks, gibbsbench.reference.design\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'pyglm_tpu_torch', 'pyglm_tpu', 'jax', 'jaxlib', 'flax'})))")
    assert out == []


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "-m", "gibbsbench.run",
                          "--workload", "flagship.high", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
