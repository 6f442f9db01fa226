"""pyglm_tpu_torch/ops/stick_breaking.py against the JAX package on the
CPU: psi_to_pi elementwise (float32 tolerance: rtol 1e-5, atol 1e-6),
pi_to_psi against a float64 evaluation no worse than twice JAX's error,
N_vec and kappa_vec exactly, the round trip (1e-2: the inverse's
cancellation), and compute_psi_cmoments (the same numpy draws, rtol
1e-4)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.ops import stick_breaking as jsb
from pyglm_tpu_torch.ops import stick_breaking as tsb

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("shape", [(7,), (50, 4), (3, 5, 6)])
def test_psi_to_pi_matches_jax(shape):
    psi = (2.0 * np.random.default_rng(0).standard_normal(shape)).astype(
        np.float32)
    got = tsb.psi_to_pi(torch.from_numpy(psi)).numpy()
    ref = np.array(jsb.psi_to_pi(jnp.asarray(psi)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    _check_inverse(ref)
    back = tsb.pi_to_psi(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, psi, rtol=1e-2, atol=1e-2)


def _pi_to_psi64(pi):
    pi = np.asarray(pi, np.float64)
    cum = np.cumsum(pi, -1)
    rem = 1.0 - np.concatenate([np.zeros_like(cum[..., :1]), cum[..., :-2]],
                               -1)
    frac = np.clip(pi[..., :-1] / np.maximum(rem, 1e-12), 1e-12, 1 - 1e-12)
    return np.log(frac) - np.log1p(-frac)


def _check_inverse(pi):
    """pi_to_psi on the same simplex points: 1 - cumsum(pi) cancels in
    float32 where little stick is left, and XLA and PyTorch sum in other
    orders, so each is held to a float64 evaluation of the same formula:
    the port's error at most twice JAX's (plus 1e-6)."""
    ref64 = _pi_to_psi64(pi)
    got = tsb.pi_to_psi(torch.from_numpy(pi)).numpy()
    jax_err = np.abs(np.asarray(jsb.pi_to_psi(jnp.asarray(pi))) - ref64)
    assert np.abs(got - ref64).max() <= 2 * jax_err.max() + 1e-6


def test_pi_to_psi_matches_jax():
    pi = np.random.default_rng(1).dirichlet(np.ones(5), size=40).astype(
        np.float32)
    _check_inverse(pi)


def test_counts_match_jax():
    y = np.random.default_rng(2).integers(0, 5, (30, 4)).astype(np.float32)
    np.testing.assert_array_equal(tsb.N_vec(y).numpy(),
                                  np.asarray(jsb.N_vec(jnp.asarray(y))))
    np.testing.assert_array_equal(tsb.kappa_vec(y).numpy(),
                                  np.asarray(jsb.kappa_vec(jnp.asarray(y))))


def test_compute_psi_cmoments_matches_jax():
    alphas = np.asarray([1.0, 2.0, 0.5, 3.0])
    m, v = tsb.compute_psi_cmoments(alphas)
    mj, vj = jsb.compute_psi_cmoments(alphas)
    np.testing.assert_allclose(m, mj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v, vj, rtol=1e-4, atol=1e-5)
