"""pyglm_tpu_torch.ops.basis against pyglm_tpu.ops.basis, elementwise
(T=500, N=6, B=4, L=10; atol 1e-5, float32)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.ops import basis as jb
from pyglm_tpu_torch.ops import basis as tb

torch.set_num_threads(1)
ATOL = 1e-5


def _spikes(seed, T=500, N=6):
    return (np.random.default_rng(seed).random((T, N)) < 0.2).astype(
        np.float32)


@pytest.mark.parametrize("B,L,orth", [(4, 10, False), (1, 8, False),
                                      (4, 12, True), (6, 30, False)])
def test_cosine_basis_matches_jax(B, L, orth):
    np.testing.assert_array_equal(tb.cosine_basis(B, L, orth=orth),
                                  jb.cosine_basis(B, L, orth=orth))


def test_convolve_with_basis_matches_jax():
    Y = _spikes(0)
    basis = jb.cosine_basis(4, 10)
    got = tb.convolve_with_basis(torch.from_numpy(Y), basis).numpy()
    ref = np.asarray(jb.convolve_with_basis(jnp.asarray(Y), basis))
    assert got.shape == ref.shape == (500, 6, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_convolve_is_causal():
    """A single spike at t0 shows up in rows t0+1 .. t0+L only."""
    Y = np.zeros((40, 2), np.float32)
    Y[10, 1] = 1.0
    basis = tb.cosine_basis(4, 10)
    X = tb.convolve_with_basis(torch.from_numpy(Y), basis).numpy()
    assert np.all(X[:11] == 0) and np.all(X[21:] == 0)
    np.testing.assert_allclose(X[11:21, 1], basis, atol=1e-7)
    assert np.all(X[:, 0] == 0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_design_matrix_matches_jax(with_bias):
    Y = _spikes(1)
    basis = jb.cosine_basis(4, 10)
    got = tb.design_matrix(torch.from_numpy(Y), basis,
                           with_bias=with_bias).numpy()
    ref = np.asarray(jb.design_matrix(jnp.asarray(Y), basis,
                                      with_bias=with_bias))
    assert got.shape == ref.shape == (500, 6 * 4 + int(with_bias))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
