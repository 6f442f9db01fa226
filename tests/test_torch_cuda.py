"""pyglm_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`; every test skips where no CUDA device is present (decided in
the fixture, at run time). The file imports no JAX, so it runs on a machine
without it; the JAX conftest is skipped there:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.ops import _build
from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
from pyglm_tpu_torch.ops.polyagamma import pg_devroye_plain, pg_mean
from pyglm_tpu_torch.ops.ss_cuda import (
    ss_edge_scan_cuda, ss_edge_scan_plain, ss_group_pass_cuda,
    ss_group_pass_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("c", [0.0, 1.5, 12.0])
def test_pg_kernel_matches_plain_distribution(gen, c):
    from scipy.stats import ks_2samp
    cv = torch.full((100_000,), c, device="cuda")
    k = pg_devroye_cuda(cv, 11, 5)
    p = pg_devroye_plain(cv, gen)
    assert torch.isfinite(k).all() and (k > 0).all()
    assert ks_2samp(k.cpu().numpy(), p.cpu().numpy()).pvalue > 1e-3
    se = float(p.std()) / np.sqrt(cv.numel())
    assert abs(float(k.mean()) - float(pg_mean(1.0, c))) < 5 * se


def test_pg_kernel_streams(gen):
    c = torch.linspace(-10, 10, 4096, device="cuda").reshape(64, 64)
    a, b = pg_devroye_cuda(c, 1, 0), pg_devroye_cuda(c, 1, 0)
    assert a.shape == c.shape and torch.equal(a, b)
    assert not torch.equal(a, pg_devroye_cuda(c, 2, 0))
    with pytest.raises(TypeError):
        pg_devroye_cuda(c.double(), 1, 0)
    with pytest.raises(ValueError):
        pg_devroye_cuda(c.T, 1, 0)


@pytest.mark.parametrize("GB", [8, 32, 64])
@pytest.mark.parametrize("case", ["first", "middle", "epilogue"])
def test_group_pass_matches_plain(gen, GB, case):
    Tn, N = 3001, 70
    X = (torch.rand((2 * GB, Tn), generator=gen, device="cuda") < 0.3).float()
    xp = None if case == "first" else X[:GB]
    xg = None if case == "epilogue" else X[GB:]
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    u = torch.randn((Tn, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    uk, up = u.clone(), u.clone()
    want = case == "first"
    out_k = ss_group_pass_cuda(xp, xg, om, uk, dw, want)
    out_p = ss_group_pass_plain(xp, xg, om, up, dw, want)
    assert _rel(uk, up) <= 1e-5
    for a, b in zip(out_k, out_p):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel(a, b) <= 1e-5


def test_group_pass_rejects_wide_groups(gen):
    x = torch.zeros((65, 100), device="cuda")
    om = torch.zeros((100, 4), device="cuda")
    with pytest.raises(ValueError):
        ss_group_pass_cuda(None, x, om, om.clone(), None)


@pytest.mark.parametrize("B", [1, 3, 4, 8])
def test_edge_scan_matches_plain(gen, B):
    G, N, Tn = 3, 150, 4000
    GB = G * B
    X = (torch.rand((GB, Tn), generator=gen, device="cuda") < 0.3).float()
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    # Residual and weights small enough that both a = 0 and a = 1 occur.
    u = 0.05 * torch.randn((Tn, N), generator=gen, device="cuda")
    m0, jgg, _ = ss_group_pass_plain(None, X, om, u, None)
    M = torch.randn((G, N, B, B), generator=gen, device="cuda")
    lam = (M @ M.transpose(-1, -2) / B
           + torch.eye(B, device="cuda")).contiguous()
    mu = 0.1 * torch.randn((G, N, B), generator=gen, device="cuda")
    lrho = torch.full((G, N), -1.0, device="cuda")
    w0 = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    u_a = torch.rand((G, N), generator=gen, device="cuda")
    eps = torch.randn((G, N, B), generator=gen, device="cuda")
    wk, wp = w0.clone(), w0.clone()
    dk, ak = ss_edge_scan_cuda(jgg, m0, wk, mu, lam, lrho, u_a, eps)
    dp, ap = ss_edge_scan_plain(jgg, m0, wp, mu, lam, lrho, u_a, eps)
    assert torch.equal(ak, ap) and 0 < float(ak.sum()) < ak.numel()
    assert float((wk - wp).abs().max()) <= 1e-4
    assert float((dk - dp).abs().max()) <= 1e-4


def test_sweep_on_card_launches_each_kernel(gen):
    from pyglm_tpu_torch import SparseBernoulliGLM
    truth = SparseBernoulliGLM(16, seed=1, device="cuda")
    Y = truth.generate(2000, keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert _build.LAUNCHES == {"pg_devroye": 3, "ss_group_pass": 3 * 5,
                               "ss_edge_scan": 3 * 4}
    assert np.isfinite(m.log_likelihood())
