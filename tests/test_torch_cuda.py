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
from pyglm_tpu_torch.ops.crt_cuda import crt_sample_cuda
from pyglm_tpu_torch.ops.linalg import crt_sample_plain
from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
from pyglm_tpu_torch.ops.polyagamma import (
    pg_devroye_plain, pg_gamma_series_plain, pg_mean, pg_var)
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
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 0,
                               "crt_sample": 0}
    assert np.isfinite(m.log_likelihood())


@pytest.mark.parametrize("b,c", [(0.3, 1.0), (2.5, 0.0), (4.5, 1.0),
                                 (40.0, 6.0)])
def test_pg_gamma_kernel_matches_plain_distribution(gen, b, c):
    from scipy.stats import ks_2samp
    n = 100_000
    bv, cv = torch.full((n,), b, device="cuda"), torch.full((n,), c,
                                                            device="cuda")
    k = pg_gamma_series_cuda(bv, cv, 21, 3)
    p = pg_gamma_series_plain(bv, cv, gen)
    assert torch.isfinite(k).all() and (k > 0).all()
    assert ks_2samp(k.cpu().numpy(), p.cpu().numpy()).pvalue > 1e-3
    se = float(pg_var(b, c)) ** 0.5 / np.sqrt(n)
    assert abs(float(k.double().mean()) - float(pg_mean(b, c))) < 6 * se


@pytest.mark.parametrize("b", [1e-3, 0.05])
def test_pg_gamma_kernel_small_b(gen, b):
    """At b << 1 most Gamma terms underflow to 0, so the law has an atom at
    the tail shift delta, which the kernel and the plain version compute in
    another rounding order (a KS test would only see that ulp): the atoms
    agree to rtol 1e-5 and hold the same share of the draws, and the means
    agree with pg_mean."""
    n, c = 200_000, 1.0
    bv, cv = torch.full((n,), b, device="cuda"), torch.full((n,), c,
                                                            device="cuda")
    k = pg_gamma_series_cuda(bv, cv, 31, 0).double()
    p = pg_gamma_series_plain(bv, cv, gen).double()
    assert torch.isfinite(k).all() and (k > 0).all()
    dk, dp = float(k.min()), float(p.min())
    assert abs(dk - dp) <= 1e-5 * dp
    share_k = float((k <= dk * (1 + 1e-5)).double().mean())
    share_p = float((p <= dp * (1 + 1e-5)).double().mean())
    assert abs(share_k - share_p) < 6 * np.sqrt(2 * share_p / n) + 1e-4
    se = float(pg_var(b, c)) ** 0.5 / np.sqrt(n)
    for x in (k, p):
        assert abs(float(x.mean()) - float(pg_mean(b, c))) < 6 * se


def test_pg_gamma_kernel_regimes_and_streams(gen):
    b = torch.tensor([0.0, -1.0, 0.5, 3.0, 200.0, 1e4], device="cuda")
    c = torch.tensor([1.0, 1.0, 1.0, -2.0, 1.0, 0.0], device="cuda")
    x = pg_gamma_series_cuda(b, c, 5, 0, normal_cutoff=170.0)
    assert torch.all(x[:2] == 0) and torch.all(x[2:] > 0)
    # Far above the cutoff the normal approximation is tight around E.
    assert abs(float(x[5]) / float(pg_mean(1e4, 0.0)) - 1) < 0.05
    assert torch.all(pg_gamma_series_cuda(b, c, 5, 0,
                                          normal_cutoff=-np.inf) > 0)
    big = torch.full((64, 64), 2.0, device="cuda")
    a1 = pg_gamma_series_cuda(big, big, 1, 0)
    assert torch.equal(a1, pg_gamma_series_cuda(big, big, 1, 0))
    assert not torch.equal(a1, pg_gamma_series_cuda(big, big, 2, 0))
    with pytest.raises(TypeError):
        pg_gamma_series_cuda(big.double(), big.double(), 1, 0)
    with pytest.raises(ValueError):
        pg_gamma_series_cuda(big.T, big, 1, 0)


@pytest.mark.parametrize("y_val,r_val", [(1, 0.5), (4, 2.0), (12, 5.0),
                                         (15, 0.7)])
def test_crt_kernel_matches_plain_law(gen, y_val, r_val):
    n = 200_000
    y = torch.full((n, 2), y_val, dtype=torch.int32, device="cuda")
    r = torch.tensor([r_val, 2 * r_val], device="cuda")
    k = crt_sample_cuda(y, r, 16, 3, 0).double()
    p = crt_sample_plain(y, r, 16, gen).double()
    for j, rj in enumerate((r_val, 2 * r_val)):
        ps = np.array([rj / (rj + i) for i in range(y_val)])
        m, v = ps.sum(), (ps * (1 - ps)).sum()
        se = np.sqrt(v / n) + 1e-6
        for x in (k[:, j], p[:, j]):
            assert abs(float(x.mean()) - m) < 6 * se
            if v > 1e-6:
                assert abs(float(x.var()) / v - 1) < 0.05
    yf = torch.tensor([[0.0, 1.0, 40.0]], device="cuda")
    lf = crt_sample_cuda(yf, torch.ones(3, device="cuda"), 16, 0, 0)
    assert lf.dtype == torch.int32 and lf[0, 0] == 0 and lf[0, 1] == 1
    assert 1 <= int(lf[0, 2]) <= 16


def test_nb_sweep_on_card_launches_k4_k2_k3(gen):
    from pyglm_tpu_torch import SparseNegativeBinomialGLM
    truth = SparseNegativeBinomialGLM(16, seed=1, obs_kwargs=dict(max_y=16),
                                      device="cuda")
    Y = np.minimum(truth.generate(2000, keep=False), 15)
    m = SparseNegativeBinomialGLM(16, seed=2, group=4,
                                  obs_kwargs=dict(max_y=16), device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert _build.LAUNCHES == {"pg_devroye": 0, "ss_group_pass": 3 * 5,
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 3,
                               "crt_sample": 0}
    assert np.isfinite(m.log_likelihood())
    r = m.state.aux["r"]
    assert r.is_cuda and torch.all(r > 0)
    aux = m.observation.resample_aux(m.generators.host, m.state.aux,
                                     m.datas[0].Y, m.datas[0].Xf @ torch.zeros(
                                         (m.P, 16), device="cuda"))
    assert _build.LAUNCHES["crt_sample"] == 1 and torch.all(aux["r"] > 0)


@pytest.mark.parametrize("n_trials,kernel", [(1, "pg_devroye"),
                                             (5, "pg_gamma_series")])
def test_binomial_sweep_on_card_dispatch(gen, n_trials, kernel):
    from pyglm_tpu_torch import NonlinearAutoregressiveModel
    kw = dict(observation="binomial", network="erdos_renyi",
              spike_and_slab=True, obs_kwargs=dict(n_trials=n_trials),
              device="cuda")
    Y = NonlinearAutoregressiveModel(16, seed=1, **kw).generate(
        2000, keep=False)
    assert Y.max() <= n_trials
    m = NonlinearAutoregressiveModel(16, seed=2, group=4, **kw)
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert _build.LAUNCHES[kernel] == 3
    assert _build.LAUNCHES["pg_devroye"] + _build.LAUNCHES[
        "pg_gamma_series"] == 3
    assert np.isfinite(m.log_likelihood())
