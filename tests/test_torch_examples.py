"""The port's examples (``examples/torch_*.py``) end to end on the CPU at
tiny sizes, each in a subprocess with ``--device cpu``: exit code 0, a
finite final log-likelihood printed, the figure written (matplotlib's Agg
backend), within 10 seconds of CPU time a case on one thread. CPU time,
not the wall clock, so that other tests running beside it do not count.
Most of a case is importing torch and matplotlib: the children share one
bytecode cache, which a first, untimed run of an example fills."""
import math
import os
import re
import resource
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "torch_synthetic_bernoulli": "--N 8 --T 2000 --samples 4 --burnin 2",
    "torch_negative_binomial": "--N 8 --T 2000 --burnin 3 --keep 3",
    "torch_sbm_network": "--N 10 --K 3 --T 2000 --sweeps 6 --burnin 3",
    "torch_convergence_diagnostics":
        "--N 8 --T 2000 --chains 3 --samples 6 --burnin 4",
    "torch_parallel_tempering":
        "--N 8 --T 2000 --samples 4 --burnin 2 --pilot 4 --rungs 3",
    "torch_checkpoint_resume": "--N 8 --T 1000 --sweeps 3 --resumed 3",
}
_LL = re.compile(r"^final log-likelihood[^=]*= \[?(-?[0-9.]+)", re.M)


def _cmd(name, out):
    return [sys.executable, str(ROOT / "examples" / f"{name}.py"),
            "--device", "cpu", "--out", str(out), *CASES[name].split()]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The children's environment, its bytecode cache filled."""
    base = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, MPLBACKEND="Agg", OMP_NUM_THREADS="1",
               PYTHONPYCACHEPREFIX=str(base / "pycache"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    subprocess.run(_cmd("torch_checkpoint_resume", base), env=env,
                   cwd=base, capture_output=True, timeout=120)
    return env


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, tmp_path, env):
    cmd = _cmd(name, tmp_path)
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=120)
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = (after.ru_utime - before.ru_utime
             + after.ru_stime - before.ru_stime)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    ll = _LL.search(res.stdout)
    assert ll and math.isfinite(float(ll.group(1))), res.stdout[-2000:]
    assert (tmp_path / f"{name}.png").exists() or \
        "matplotlib unavailable" in res.stdout
    assert cpu_s < 10.0, f"{name} took {cpu_s:.1f} s of CPU"


def test_every_jax_example_has_a_port():
    jax_examples = {p.stem for p in (ROOT / "examples").glob("*.py")
                    if not p.stem.startswith("torch_")}
    assert {f"torch_{s}" for s in jax_examples} <= {
        p.stem for p in (ROOT / "examples").glob("torch_*.py")}
