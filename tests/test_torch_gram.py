"""The group-Gram blocks of pyglm_tpu_torch (ops/gram_cuda.py, the module of
kernel K6, dispatched by models/weights.py::group_gram_blocks) against the
JAX package on the CPU, where the dispatch takes the plain version.

The reference is weights.group_gram_blocks(precision="highest"), the XLA
Gram the JAX suite holds its Pallas kernel against on the CPU. Gate:
max|diff| / max|ref| <= 1e-5 (float32 sums over T terms in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops import gram_cuda
from pyglm_tpu_torch.ops.ss_cuda import unpack_gram

torch.set_num_threads(1)
REL_TOL = 1e-5


def _inputs(T, N_pre, B, lanes, seed):
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N_pre)) < 0.2).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))
    omega = (0.05 + 0.3 * rng.random((T, lanes))).astype(np.float32)
    return Xf, omega


@pytest.mark.parametrize("T,N_pre,B,G,lanes", [
    (512, 8, 4, 2, 16),       # T a multiple of 512, GB = 8
    (700, 6, 4, 3, 20),       # GB = 12 (not a multiple of 8), ragged T
    (333, 10, 2, 5, 7),       # GB = 10, lanes < 8
    (1200, 9, 3, 9, 130),     # one group of GB = 27, lanes over 128
])
def test_group_gram_matches_jax(T, N_pre, B, G, lanes):
    Xf, omega = _inputs(T, N_pre, B, lanes, seed=T)
    ref = np.asarray(jw.group_gram_blocks(jnp.asarray(Xf), jnp.asarray(omega),
                                          B, G, precision="highest"))
    got = tw.group_gram_blocks(torch.from_numpy(Xf.T.copy()),
                               torch.from_numpy(omega), B, G, packed=False)
    assert got.shape == ref.shape == (N_pre // G, lanes, G * B, G * B)
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    assert err <= REL_TOL, err


def test_packed_round_trip_and_layout():
    T, N_pre, B, G, lanes = 400, 6, 2, 3, 5
    Xf, omega = _inputs(T, N_pre, B, lanes, seed=1)
    Xt = torch.from_numpy(Xf.T.copy())
    packed = tw.group_gram_blocks(Xt, torch.from_numpy(omega), B, G)
    GB = G * B
    assert packed.shape == (N_pre // G, GB * (GB + 1) // 2, lanes)
    full = tw.group_gram_blocks(Xt, torch.from_numpy(omega), B, G,
                                packed=False)
    for g in range(N_pre // G):
        torch.testing.assert_close(unpack_gram(packed[g], GB), full[g],
                                   rtol=0, atol=0)
        iu = torch.triu_indices(GB, GB)
        torch.testing.assert_close(full[g][:, iu[0], iu[1]].T, packed[g],
                                   rtol=0, atol=0)
        assert torch.equal(full[g], full[g].transpose(-1, -2))


def test_dispatch_plain_on_cpu_and_rejections():
    T, N_pre, B, G, lanes = 300, 4, 4, 2, 6
    Xf, omega = _inputs(T, N_pre, B, lanes, seed=2)
    Xt, om = torch.from_numpy(Xf.T.copy()), torch.from_numpy(omega)
    torch.testing.assert_close(tw.group_gram_blocks(Xt, om, B, G),
                               gram_cuda.group_gram_blocks_plain(Xt, om, B, G),
                               rtol=0, atol=0)
    bf16 = gram_cuda.group_gram_blocks_plain(Xt, om, B, G,
                                             precision="default")
    for kw in (dict(fast=True), dict(precision="default")):
        torch.testing.assert_close(tw.group_gram_blocks(Xt, om, B, G, **kw),
                                   bf16, rtol=0, atol=0)
    with pytest.raises(ValueError):
        gram_cuda.group_gram_blocks_plain(Xt, om, B, G, precision="sr")
    with pytest.raises(ValueError):
        gram_cuda.group_gram_blocks_cuda(Xt, om, B, G)
    with pytest.raises(ValueError):
        tw.group_gram_blocks(Xt.to("meta"), om.to("meta"), B, G)
    with pytest.raises(ValueError, match="does not divide"):
        tw.group_gram_blocks(Xt, om, B, 3)
