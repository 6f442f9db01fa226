"""The port's own exact PG oracle (``pyglm_tpu_torch/native``) against the
JAX package's: the same C++ source, byte for byte, and the same draws for
the same seed and thread count; its draws' means against pg_mean."""
import numpy as np
import pytest

from pyglm_tpu import native as jn
from pyglm_tpu_torch import native as tn
from pyglm_tpu_torch.ops.polyagamma import pg_mean, pg_var


def _need_both():
    if not (tn.native_available() and jn.native_available()):
        pytest.skip("no C++ toolchain for the native PG oracle")


def test_source_is_the_jax_packages_byte_for_byte():
    assert tn._SRC.read_bytes() == (
        tn._SRC.parents[2] / "pyglm_tpu" / "native" / "pg_sampler.cpp"
    ).read_bytes()


def test_library_builds_outside_the_package():
    _need_both()
    assert tn._LIB.exists() and tn._LIB.parent.name == "pyglm_tpu_torch"
    assert tn._LIB.parent.parent.name == "build"
    assert not list(tn._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("n_threads", [1, 3])
def test_loaders_give_identical_draws(n_threads):
    _need_both()
    c = np.linspace(0.0, 12.0, 3001)
    b = np.tile([1.0, 2.0, 5.0, 17.0], 750)
    np.testing.assert_array_equal(
        tn.pg_devroye_native(c, seed=5, n_threads=n_threads),
        jn.pg_devroye_native(c, seed=5, n_threads=n_threads))
    np.testing.assert_array_equal(
        tn.pg_int_b_native(b, 1.5, seed=6, n_threads=n_threads),
        jn.pg_int_b_native(b, 1.5, seed=6, n_threads=n_threads))
    assert not np.array_equal(tn.pg_devroye_native(c, seed=5, n_threads=1),
                              tn.pg_devroye_native(c, seed=7, n_threads=1))


@pytest.mark.parametrize("b,c", [(1, 0.0), (1, 2.0), (5, 0.5), (17, 10.0)])
def test_oracle_mean(b, c):
    _need_both()
    n = 40_000
    x = tn.pg_int_b_native(np.full(n, float(b)), c, seed=b, n_threads=2)
    assert x.shape == (n,) and x.dtype == np.float64 and (x > 0).all()
    se = np.sqrt(float(pg_var(float(b), c)) / n)
    assert abs(x.mean() - float(pg_mean(float(b), c))) < 5 * se
