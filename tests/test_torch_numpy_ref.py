"""The port's copy of the f64 NumPy oracle (pyglm_tpu_torch/reference/
numpy_ref.py) against the JAX package's original, and the port's import
boundary.

(a) With the same seeds and data, the copy gives bit-identical chains to
    pyglm_tpu/reference/numpy_ref.py for 10 sweeps of the Bernoulli-ER, NB,
    latent-distance, dense-NIW, Gaussian and SBM configs of
    tests/test_numpy_parity.py (every state field and the log-likelihood
    equal, not close), and for 10 resamples of the stick-breaking
    multinomial regression's oracle (A, b and pi equal);
(b) the copy imports no torch, and no module of pyglm_tpu_torch nor
    chip_smoke.py imports jax, pyglm_tpu or benchmarks (by the AST, so
    imports inside functions count too).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

from pyglm_tpu.reference import numpy_ref as jax_ref
from pyglm_tpu_torch.ops.basis import cosine_basis
from pyglm_tpu_torch.reference import numpy_ref as port_ref

ROOT = Path(__file__).resolve().parents[1]
N_SWEEPS = 10

# The configs of tests/test_numpy_parity.py (N=5, B=2, L=4), the data made
# from a numpy seed.
CONFIGS = {
    "bernoulli_er": dict(
        T=1500, kw=dict(rho=0.35, mu_w=0.0, sigma_w=0.8, mu_b=-1.2,
                        sigma_b=0.4)),
    "negative_binomial": dict(
        T=1000, kw=dict(rho=0.35, mu_w=0.0, sigma_w=0.01, mu_b=-2.0,
                        sigma_b=0.3, observation="negative_binomial",
                        r_init=2.0, a_r=2.0, b_r=0.5)),
    "latent_distance": dict(
        T=1500, kw=dict(rho=0.35, sigma_w=0.5, mu_b=-1.0, sigma_b=0.4,
                        network="latent_distance", dim=2, sigma_l=1.0,
                        sigma_gamma=2.0, niw_kappa0=1.0, niw_psi0=1.0)),
    "dense_niw": dict(
        T=1500, kw=dict(sigma_w=0.05, mu_b=-1.0, sigma_b=0.4,
                        network="dense", niw_kappa0=1.0, niw_psi0=1.0)),
    "gaussian": dict(
        T=2000, kw=dict(rho=0.35, mu_w=0.0, sigma_w=0.05, mu_b=0.3,
                        sigma_b=0.4, observation="gaussian", eta_init=1.0,
                        a_eta=2.0, b_eta=1.0)),
    "sbm": dict(
        T=1500, kw=dict(rho=0.35, sigma_w=0.5, mu_b=-1.0, sigma_b=0.4,
                        network="sbm", K=2, alpha_pi=1.0, a_rho=1.0,
                        b_rho=1.0, niw_kappa0=1.0, niw_psi0=1.0)),
}
# The extra state fields each network keeps.
NET_FIELDS = {"latent_distance": ["Lpos", "gamma", "mu_sh", "Sigma_sh"],
              "dense_niw": ["mu_sh", "Sigma_sh"],
              "sbm": ["c", "pi", "rho_blk", "mu_blk", "Sigma_blk"]}


def _data(name, T):
    rng = np.random.default_rng(11)
    if name == "negative_binomial":
        return np.minimum(rng.negative_binomial(2, 0.7, (T, 5)),
                          63).astype(np.float64)
    if name == "gaussian":
        return 0.3 + 0.6 * rng.standard_normal((T, 5))
    return (rng.random((T, 5)) < 0.25).astype(np.float64)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_copy_gives_bit_identical_chains(name):
    cfg = CONFIGS[name]
    basis = np.asarray(cosine_basis(B=2, L=4), np.float64)
    Y = _data(name, cfg["T"])
    a = jax_ref.NumpyGLMReference(N=5, B=2, basis=basis, seed=7, **cfg["kw"])
    b = port_ref.NumpyGLMReference(N=5, B=2, basis=basis, seed=7,
                                   **cfg["kw"])
    Xa, Xb = a.design(Y), b.design(Y)
    np.testing.assert_array_equal(Xa, Xb)
    for _ in range(N_SWEEPS):
        a.resample(Y, Xa)
        b.resample(Y, Xb)
    fields = ["A", "W", "b", "r", "eta"] + NET_FIELDS.get(name, [])
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.log_likelihood(Y, Xa) == b.log_likelihood(Y, Xb)
    # The chain moved (10 sweeps are not a no-op).
    assert a.A.sum() > 0 and np.abs(a.W).sum() > 0


def test_multinomial_copy_gives_bit_identical_chains():
    rng = np.random.default_rng(12)
    X = rng.standard_normal((300, 3))
    Y = rng.multinomial(5, [0.2, 0.3, 0.1, 0.4], size=300).astype(np.float64)
    a = jax_ref.NumpyMultinomialRegression(4, 3, seed=7)
    b = port_ref.NumpyMultinomialRegression(4, 3, seed=7)
    for _ in range(N_SWEEPS):
        a.resample(X, Y)
        b.resample(X, Y)
    np.testing.assert_array_equal(a.A, b.A)
    np.testing.assert_array_equal(a.b, b.b)
    np.testing.assert_array_equal(a.pi(X), b.pi(X))
    assert np.abs(a.A).sum() > 0


def _imports(path):
    """Top-level names of every module `path` imports, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_oracle_copy_imports_no_torch():
    names = _imports(ROOT / "pyglm_tpu_torch" / "reference" / "numpy_ref.py")
    assert names <= {"__future__", "numpy", "scipy"}, names


def test_port_and_chip_smoke_import_no_jax_package():
    files = sorted((ROOT / "pyglm_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): sorted(
        _imports(f) & {"jax", "jaxlib", "pyglm_tpu", "benchmarks"})
        for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad
