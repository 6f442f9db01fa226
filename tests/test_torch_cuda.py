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
from pyglm_tpu_torch.ops.crt_cuda import (
    crt_sample_cuda, crt_sample_sums_cuda, crt_sample_twin)
from pyglm_tpu_torch.ops.gram_cuda import (
    group_gram_blocks_cuda, group_gram_blocks_plain)
from pyglm_tpu_torch.ops.linalg import crt_sample_plain
from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
from pyglm_tpu_torch.ops.pg_gamma_cuda import pg_gamma_series_cuda
from pyglm_tpu_torch.ops.polyagamma import (
    pg_devroye_plain, pg_gamma_series_plain, pg_mean, pg_var)
from pyglm_tpu_torch.ops.ss_cuda import (
    pair_index, sr_round, sr_words, ss_edge_scan_cuda, ss_edge_scan_plain,
    ss_group_pass_cuda, ss_group_pass_plain, to_bf16)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("c", [0.0, 0.5, 1.5, 2.0, 3.0, 3.25, 8.0, 12.0,
                               30.0])
def test_pg_kernel_matches_plain_distribution(gen, c):
    """K1 against its plain version (KS p > 1e-3) and pg_mean (5 standard
    errors); c = 3.0 and 3.25 straddle the switch from the tilted Levy to
    the Michael-Schucany-Haas proposal at c = 3.125."""
    from scipy.stats import ks_2samp
    cv = torch.full((100_000,), c, device="cuda")
    k = pg_devroye_cuda(cv, 11, 5)
    p = pg_devroye_plain(cv, gen)
    assert torch.isfinite(k).all() and (k > 0).all()
    assert ks_2samp(k.cpu().numpy(), p.cpu().numpy()).pvalue > 1e-3
    se = float(p.std()) / np.sqrt(cv.numel())
    assert abs(float(k.mean()) - float(pg_mean(1.0, c))) < 5 * se


def test_pg_kernel_interleaved_proposal_kinds(gen):
    """K1 on c = 0.5, 3.0, 3.25, 8 repeated, so every warp's chunk holds
    tilted Levy and Michael-Schucany-Haas elements side by side and orders
    them (Levy first, MSH after) before its lanes refill across the two:
    each c's draws against the plain version's (KS p > 1e-3) and pg_mean
    (5 standard errors)."""
    from scipy.stats import ks_2samp
    cs = [0.5, 3.0, 3.25, 8.0]
    cv = torch.tensor(cs, device="cuda").repeat(100_000)
    k = pg_devroye_cuda(cv, 13, 7)
    p = pg_devroye_plain(cv, gen)
    assert torch.isfinite(k).all() and (k > 0).all()
    for i, c in enumerate(cs):
        ki, pi = k[i::len(cs)], p[i::len(cs)]
        assert ks_2samp(ki.cpu().numpy(), pi.cpu().numpy()).pvalue > 1e-3, c
        se = float(pi.std()) / np.sqrt(ki.numel())
        assert abs(float(ki.mean()) - float(pg_mean(1.0, c))) < 5 * se, c


def test_pg_kernel_streams(gen):
    c = torch.linspace(-10, 10, 4096, device="cuda").reshape(64, 64)
    a, b = pg_devroye_cuda(c, 1, 0), pg_devroye_cuda(c, 1, 0)
    assert a.shape == c.shape and torch.equal(a, b)
    assert not torch.equal(a, pg_devroye_cuda(c, 2, 0))
    with pytest.raises(TypeError):
        pg_devroye_cuda(c.double(), 1, 0)
    with pytest.raises(ValueError):
        pg_devroye_cuda(c.T, 1, 0)


@pytest.mark.parametrize("N", [70, 200])
@pytest.mark.parametrize("GB", [4, 8, 12, 32, 40, 64])
@pytest.mark.parametrize("case", ["first", "middle", "epilogue"])
def test_group_pass_matches_plain(gen, GB, case, N):
    """K2 (its Gram 3xTF32 on wgmma, precision "high") against its plain
    version at a T that is not a multiple of the 32-step stage, 70 and 200
    lanes."""
    Tn = 3001
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


def test_group_pass_repeats_bit_for_bit(gen):
    GB, Tn, N = 32, 5000, 200
    X = (torch.rand((2 * GB, Tn), generator=gen, device="cuda") < 0.3).float()
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    u = torch.randn((Tn, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    u1, u2 = u.clone(), u.clone()
    a = ss_group_pass_cuda(X[:GB], X[GB:], om, u1, dw, True)
    b = ss_group_pass_cuda(X[:GB], X[GB:], om, u2, dw, True)
    assert torch.equal(u1, u2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("N", [13, 70, 200, 257])
@pytest.mark.parametrize("GB", [4, 12, 32, 40])
@pytest.mark.parametrize("case", ["first", "middle", "epilogue"])
@pytest.mark.parametrize("precision", ["default", "sr"])
def test_group_pass_reads_the_bf16_stream_alone(gen, precision, case, GB,
                                               N):
    """K2 at "default" and "sr" given only omega's bf16 stream (row stride
    N8, here N8 != N at 13, 70 and 257 lanes): its scatter, M0 and sum_t
    omega equal bit for bit those of K2 at "high" on the float32 rounded
    omega (the same fp32 arithmetic on the same values), and its u, M0,
    Gram and sum agree with the plain version on the stream (1e-5)."""
    from pyglm_tpu_torch.ops.ss_cuda import omega_bf16_stream
    Tn = 3001
    X = _float_design(gen, 2 * GB, Tn)
    xp = None if case == "first" else X[:GB]
    xg = None if case == "epilogue" else X[GB:]
    om = to_bf16(0.05 + 0.2 * torch.rand((Tn, N), generator=gen,
                                         device="cuda"))
    om16 = omega_bf16_stream(om)
    u = torch.randn((Tn, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    seed, offset = 321, 9
    want = case != "epilogue"
    uk, uh, up = u.clone(), u.clone(), u.clone()
    out_k = ss_group_pass_cuda(xp, xg, None, uk, dw, want,
                               precision=precision, sr_seed=(seed, offset),
                               om16=om16)
    out_h = ss_group_pass_cuda(xp, xg, om, uh, dw, want)
    r16 = (sr_words(seed, offset, GB * (GB + 1) // 2, Tn).cuda()
           if precision == "sr" and xg is not None else None)
    out_p = ss_group_pass_plain(xp, xg, None, up, dw, want,
                                precision=precision, r16=r16, om16=om16)
    assert torch.equal(uk, uh)
    assert _rel(uk, up) <= 1e-5
    if case == "epilogue":
        assert out_k == (None, None, None)
        return
    assert torch.equal(out_k[0], out_h[0]) and torch.equal(out_k[2],
                                                           out_h[2])
    for a, b in zip(out_k, out_p):
        assert _rel(a, b) <= 1e-5


def _f64_errors(kernel_gram, plain_gram, X, om, p, q):
    j64 = (X[p].double() * X[q].double()) @ om.double()
    return _rel(kernel_gram.double(), j64), _rel(plain_gram.double(), j64)


def _design(gen, n_pre, T, B=4, rate=0.15):
    """The main path's design rows: spikes convolved with the cosine basis,
    (n_pre B + 1, T) with the bias row last."""
    from pyglm_tpu_torch.ops.basis import cosine_basis, design_matrix
    Y = (torch.rand((T, n_pre), generator=gen, device="cuda") < rate).float()
    return design_matrix(Y, cosine_basis(B, 10)).T.contiguous()


@pytest.mark.parametrize("precision", ["high", "default", "sr"])
def test_group_pass_gram_error_against_float64(gen, precision):
    """At the flagship's shapes and inputs (GB = 32, T = 1e5, 200 lanes, a
    design of spikes at rate 0.15 and the cosine basis, PG-like omega), K2's
    Gram is no further from a float64 Gram of the same operands (rounded to
    bf16 at "default", Z rounded by the kernel's own Philox words at "sr")
    than 2x the plain version (cuBLAS SGEMM on the materialised Z)."""
    GB, Tn, N = 32, 100_000, 200
    X = _design(gen, GB // 4, Tn)[:GB]
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    u = torch.randn((Tn, N), generator=gen, device="cuda")
    p, q = pair_index(GB, "cuda")
    sr_seed = (77, 5)
    r16 = (sr_words(*sr_seed, GB * (GB + 1) // 2, Tn).cuda()
           if precision == "sr" else None)
    _, jk, _ = ss_group_pass_cuda(None, X, om, u.clone(), None,
                                  precision=precision, sr_seed=sr_seed)
    _, jp, _ = ss_group_pass_plain(None, X, om, u.clone(), None,
                                   precision=precision, r16=r16)
    if precision == "high":
        ek, ep = _f64_errors(jk, jp, X, om, p, q)
    else:
        Z = X[p] * X[q]
        Z = sr_round(Z, r16) if precision == "sr" else to_bf16(Z)
        j64 = Z.double() @ to_bf16(om).double()
        ek, ep = _rel(jk.double(), j64), _rel(jp.double(), j64)
    assert ek <= 2 * ep, (ek, ep)


@pytest.mark.parametrize("lanes", [7, 70, 200, 257, 1000])
@pytest.mark.parametrize("GB", [1, 4, 12, 32, 40, 64])
def test_group_pass_tf32_matches_plain(gen, GB, lanes):
    """K2's 3xTF32 Gram (the TF32 mode of the wgmma tile, "high") against
    its plain version at T = 40 (less than one 32-step stage), 3001 and
    4099 (ragged against the stage; several splits of T where the group is
    small): every pair tile of 136 rows (GB = 64 has 16), lanes ragged
    against 4 (4-byte copies of omega), 8 and 128, continuous design and
    omega (nonzero lo halves); within 1e-5, bit-repeatable."""
    npair = GB * (GB + 1) // 2
    for Tn in (40, 3001, 4099):
        X = _float_design(gen, GB, Tn)
        om = 0.05 + 0.2 * torch.rand((Tn, lanes), generator=gen,
                                     device="cuda")
        u = torch.zeros((Tn, lanes), device="cuda")
        jk = ss_group_pass_cuda(None, X, om, u, None)[1]
        jp = ss_group_pass_plain(None, X, om, u, None)[1]
        assert jk.shape == (npair, lanes)
        assert _rel(jk, jp) <= 1e-5, (Tn, _rel(jk, jp))
        assert torch.equal(jk, ss_group_pass_cuda(None, X, om, u, None)[1])


def _float_design(gen, GB, Tn):
    """Design rows of continuous values, so that Z = X_p X_q is rarely a
    bf16 value and the rounding of the bf16 modes shows."""
    return torch.rand((GB, Tn), generator=gen, device="cuda") * (
        torch.rand((GB, Tn), generator=gen, device="cuda") < 0.5)


@pytest.mark.parametrize("N", [70, 200])
@pytest.mark.parametrize("GB", [8, 12, 32, 40])
@pytest.mark.parametrize("precision", ["default", "sr"])
def test_group_pass_bf16_modes_match_plain(gen, precision, GB, N):
    """K2's bf16 and SR Grams against their plain versions on the same
    rounding words (sr_words repeats the kernel's Philox draw): the products
    of bf16 values are exact, so only the order of the fp32 sums differs
    (1e-5). At "sr" the words of another seed give another Gram (> 1e-5),
    so the first agreement shows that the words are the same."""
    Tn = 3001
    X = _float_design(gen, 2 * GB, Tn)
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    u = torch.randn((Tn, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    seed, offset = 12345, 678
    r16 = (sr_words(seed, offset, GB * (GB + 1) // 2, Tn).cuda()
           if precision == "sr" else None)
    uk, up = u.clone(), u.clone()
    out_k = ss_group_pass_cuda(X[:GB], X[GB:], om, uk, dw, True,
                               precision=precision, sr_seed=(seed, offset))
    out_p = ss_group_pass_plain(X[:GB], X[GB:], om, up, dw, True,
                                precision=precision, r16=r16)
    assert _rel(uk, up) <= 1e-5
    for a, b in zip(out_k, out_p):
        assert _rel(a, b) <= 1e-5
    if precision == "sr":
        other = ss_group_pass_cuda(None, X[GB:], om, u.clone(), None,
                                   precision="sr",
                                   sr_seed=(seed + 1, offset))[1]
        assert _rel(other, out_p[1]) > 1e-5
        again = ss_group_pass_cuda(None, X[GB:], om, u.clone(), None,
                                   precision="sr", sr_seed=(seed, offset))[1]
        assert torch.equal(again, out_k[1])


@pytest.mark.parametrize("lanes", [7, 70, 200, 257, 1000])
@pytest.mark.parametrize("GB", [1, 4, 12, 32, 40, 64])
@pytest.mark.parametrize("precision", ["default", "sr"])
def test_group_pass_wgmma_matches_plain(gen, precision, GB, lanes):
    """K2's wgmma Gram body at "default" and "sr" against its plain version
    (on the same rounding words at "sr") at T = 40 (less than one 64-step
    stage), 3001 and 4099 (ragged against the stage and, by the split plan,
    several splits where the group is small): every pair tile (GB = 64 has
    13), lanes ragged against 8 and 128; given the bf16 omega stream and
    without it. Exact bf16 products, so only the fp32 sum order differs
    (1e-5); another seed's words give another Gram; results repeat bit for
    bit."""
    from pyglm_tpu_torch.ops.ss_cuda import omega_bf16_stream
    seed, offset = 4242, 17
    npair = GB * (GB + 1) // 2
    for Tn in (40, 3001, 4099):
        X = _float_design(gen, GB, Tn)
        om = to_bf16(0.05 + 0.2 * torch.rand((Tn, lanes), generator=gen,
                                             device="cuda"))
        u = torch.zeros((Tn, lanes), device="cuda")
        r16 = (sr_words(seed, offset, npair, Tn).cuda()
               if precision == "sr" else None)

        def k2(sd=seed, om16=None):
            return ss_group_pass_cuda(None, X, om, u, None,
                                      precision=precision,
                                      sr_seed=(sd, offset), om16=om16)[1]
        jk = k2()
        jp = ss_group_pass_plain(None, X, om, u, None, precision=precision,
                                 r16=r16)[1]
        assert jk.shape == (npair, lanes)
        assert _rel(jk, jp) <= 1e-5, (Tn, _rel(jk, jp))
        assert torch.equal(jk, k2()), Tn
        assert torch.equal(jk, k2(om16=omega_bf16_stream(om))), Tn
        if precision == "sr":
            assert _rel(k2(seed + 1), jp) > 1e-5, Tn


def test_group_pass_sr_unbiased_over_launches(gen):
    """K2's SR Gram over R = 256 launches with different seeds (GB = 32,
    T = 4096, 256 lanes): the per-cell mean minus the float64 Gram of the
    fp32 Z and the bf16 omega has max |z| < 6, its RMS error is below half
    that of the "default" Gram (expected ~0.09x: one SR launch errs ~1.4x
    the RNE Gram, and 256 launches cut that 16x), and a seed repeats."""
    GB, Tn, N, R = 32, 4096, 256, 256
    X = _float_design(gen, GB, Tn)
    om = to_bf16(0.05 + 0.2 * torch.rand((Tn, N), generator=gen,
                                         device="cuda"))
    u = torch.zeros((Tn, N), device="cuda")
    p, q = pair_index(GB, "cuda")
    ref = (X[p] * X[q]).double() @ om.double()
    s1 = torch.zeros_like(ref)
    s2 = torch.zeros_like(ref)
    for r in range(R):
        j = ss_group_pass_cuda(None, X, om, u, None, precision="sr",
                               sr_seed=(1000 + r, 7))[1].double()
        s1 += j
        s2 += j * j
    mean = s1 / R
    se = ((s2 / R - mean ** 2).clamp_min(0) * R / (R - 1) / R).sqrt()
    live = se > 0
    z = ((mean - ref).abs() / se)[live]
    assert float(z.max()) < 6.0, float(z.max())
    if bool((~live).any()):        # cells whose Z needs no rounding
        assert float((mean - ref)[~live].abs().max()) <= 1e-6 * float(
            ref.abs().max())
    dflt = ss_group_pass_cuda(None, X, om, u, None,
                              precision="default")[1].double()
    rms_sr = float((mean - ref).pow(2).mean().sqrt())
    rms_default = float((dflt - ref).pow(2).mean().sqrt())
    assert rms_sr < 0.5 * rms_default, (rms_sr, rms_default)
    a = ss_group_pass_cuda(None, X, om, u, None, precision="sr",
                           sr_seed=(3, 4))[1]
    b = ss_group_pass_cuda(None, X, om, u, None, precision="sr",
                           sr_seed=(3, 4))[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["high", "default", "sr"])
def test_group_pass_m0_error_against_float64(gen, precision):
    """At the flagship group's shapes (GB = 32, T = 1e5, 200 lanes, a
    design of spikes and the cosine basis, a middle group: scatter, then
    gather), K2's M0 (the fp32 streaming pass, in every mode) is no further
    from the float64 M0 of the u it has just written than 2x the fp32
    plain version's (xg @ u, cuBLAS SGEMM with TF32 off) on that u."""
    from pyglm_tpu_torch.ops.ss_cuda import omega_bf16_stream
    GB, Tn, N = 32, 100_000, 200
    X = _design(gen, 2 * GB // 4, Tn)[:2 * GB]
    om = 0.05 + 0.2 * torch.rand((Tn, N), generator=gen, device="cuda")
    kw = {}
    if precision != "high":
        om = to_bf16(om)
        kw["om16"] = omega_bf16_stream(om)
    u = 0.5 * torch.randn((Tn, N), generator=gen, device="cuda")
    dw = 0.1 * torch.randn((GB, N), generator=gen, device="cuda")
    m0 = ss_group_pass_cuda(X[:GB], X[GB:], om, u, dw, precision=precision,
                            sr_seed=(3, 4), **kw)[0]
    m64 = X[GB:].double() @ u.double()
    ek, ep = _rel(m0.double(), m64), _rel((X[GB:] @ u).double(), m64)
    assert ek <= 2 * ep, (ek, ep)


@pytest.mark.parametrize("precision,key", [("high", "ss_group_pass"),
                                           ("default", "ss_group_pass_bf16"),
                                           ("sr", "ss_group_pass_sr")])
def test_fused_sweep_launches_one_stream_pass_per_k2_call(gen, precision,
                                                          key):
    """A fused sweep at the flagship's width (200 lanes in 25 groups of GB
    = 32: 26 K2 calls; T = 20000 bins of random spikes) launches K2's
    streaming pass once per K2 call, counted by torch.profiler beside the
    wrapper's count, and no other scatter or M0 kernel (the earlier
    scatter_kernel and mma.sync m0_tc_kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    Y = (torch.rand((20_000, 200), generator=gen, device="cuda")
         < 0.05).float()
    m = SparseBernoulliGLM(200, seed=2, precision=precision, device="cuda")
    m.add_data(Y)
    m.fit(n_samples=1)
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m.fit(n_samples=1)
        torch.cuda.synchronize()
    assert weights.LAST_SS_PATH == "fused"
    assert _build.LAUNCHES[key] == 26
    counts = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA":
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    n_pass = sum(c for k, c in counts.items() if "stream_pass_kernel" in k)
    assert n_pass == 26, counts
    assert not any("m0_tc_kernel" in k or "scatter_kernel" in k
                   for k in counts), sorted(counts)


def test_group_pass_rejects_wide_groups(gen):
    x = torch.zeros((65, 100), device="cuda")
    om = torch.zeros((100, 4), device="cuda")
    with pytest.raises(ValueError):
        ss_group_pass_cuda(None, x, om, om.clone(), None)


def _edge_scan_problem(gen, G, B, N, Tn=4000):
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
    return jgg, m0, w0, mu, lam, lrho, u_a, eps


def _edge_scan_agrees(jgg, m0, w0, *rest):
    wk, wp = w0.clone(), w0.clone()
    dk, ak = ss_edge_scan_cuda(jgg, m0, wk, *rest)
    dp, ap = ss_edge_scan_plain(jgg, m0, wp, *rest)
    assert torch.equal(ak, ap) and 0 < float(ak.sum()) < ak.numel()
    assert float((wk - wp).abs().max()) <= 1e-4
    assert float((dk - dp).abs().max()) <= 1e-4


@pytest.mark.parametrize("G,B,N", [(3, 1, 150), (3, 3, 150), (3, 4, 150),
                                   (3, 8, 150), (10, 4, 4001)])
def test_edge_scan_matches_plain(gen, G, B, N):
    """At the plan's lane tile; 4001 lanes leave a ragged last tile."""
    _edge_scan_agrees(*_edge_scan_problem(gen, G, B, N))


@pytest.mark.parametrize("N", [200, 203])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_edge_scan_every_lane_tile_matches_plain(gen, monkeypatch, tile, N):
    """Every lane tile the kernel takes, forced, with 16-byte copies (200
    lanes) and 4-byte ones (203)."""
    from pyglm_tpu_torch.ops import ss_cuda
    monkeypatch.setattr(ss_cuda, "edge_scan_plan", lambda *a: tile)
    _edge_scan_agrees(*_edge_scan_problem(gen, 8, 4, N))


def test_sweep_on_card_launches_each_kernel(gen):
    from pyglm_tpu_torch import SparseBernoulliGLM
    truth = SparseBernoulliGLM(16, seed=1, device="cuda")
    Y = truth.generate(2000, keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert _build.LAUNCHES == {"pg_devroye": 3, "ss_group_pass": 3 * 5,
                               "ss_group_pass_bf16": 0, "ss_group_pass_sr": 0,
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 0,
                               "crt_sample": 0, "crt_sample_sums": 0,
                               "group_gram": 0, "group_gram_bf16": 0}
    assert np.isfinite(m.log_likelihood())


@pytest.mark.parametrize("precision,key", [("default", "ss_group_pass_bf16"),
                                           ("sr", "ss_group_pass_sr")])
def test_bf16_mode_sweep_launches_its_k2_body(gen, precision, key):
    """A flagship-shaped sweep at "default" / "sr" runs the fused loop on
    K2's bf16 / SR Gram (Ng + 1 calls per sweep) and no other Gram body."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    Y = SparseBernoulliGLM(16, seed=1, device="cuda").generate(2000,
                                                                keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, precision=precision,
                           device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    out = m.fit(n_samples=3)
    assert weights.LAST_SS_PATH == "fused"
    want = {k: 0 for k in _build.LAUNCHES}
    want.update(pg_devroye=3, ss_edge_scan=3 * 4, **{key: 3 * 5})
    assert _build.LAUNCHES == want
    assert np.isfinite(out["lls"]).all() and np.isfinite(m.log_likelihood())


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


def _crt_inputs(T_, N_, seed):
    rng = np.random.default_rng(seed)
    y = rng.poisson(3.0, (T_, N_)).astype(np.int32)
    y[::5, ::4] += 40                        # past max_y = 16
    r = rng.uniform(0.2, 6.0, N_).astype(np.float32)
    return y, r


@pytest.mark.parametrize("N_", [27, 200])
def test_crt_kernel_equals_twin(gen, N_):
    """K5's per-element counts equal its numpy twin bit for bit (int and
    float y, counts past max_y, a y that starts off 16-byte alignment)."""
    y, r = _crt_inputs(301, N_, N_)
    rc = torch.from_numpy(r).cuda()
    want = crt_sample_twin(y, r, 16, 2 ** 40 + 3, 17)
    yc = torch.from_numpy(y).cuda()
    for yy in (yc, yc.float()):
        got = crt_sample_cuda(yy, rc, 16, 2 ** 40 + 3, 17)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    # rows 1.. of y in place: at N = 27 not 16-byte aligned (scalar loads)
    yo = yc.view(-1)[N_:].view(300, N_)
    np.testing.assert_array_equal(crt_sample_cuda(yo, rc, 16, 5, 0).cpu()
                                  .numpy(), crt_sample_twin(y[1:], r, 16, 5,
                                                            0))


@pytest.mark.parametrize("N_", [27, 200])
def test_crt_sums_equal_counts_summed_and_repeat(gen, N_):
    y, r = _crt_inputs(2000, N_, 7 + N_)
    yc, rc = torch.from_numpy(y).cuda(), torch.from_numpy(r).cuda()
    for max_y, seed, off in ((16, 3, 0), (64, 2 ** 63 + 1, 2 ** 33)):
        l = crt_sample_cuda(yc, rc, max_y, seed, off)
        s = crt_sample_sums_cuda(yc, rc, max_y, seed, off)
        assert s.dtype == torch.int64 and s.shape == (N_,)
        assert torch.equal(s, l.sum(0))
        assert torch.equal(s, crt_sample_sums_cuda(yc.float(), rc, max_y,
                                                   seed, off))
        assert torch.equal(l, crt_sample_cuda(yc, rc, max_y, seed, off))
        assert torch.equal(s, crt_sample_sums_cuda(yc, rc, max_y, seed, off))
        assert not torch.equal(l, crt_sample_cuda(yc, rc, max_y, seed,
                                                  off + 1))


@pytest.mark.parametrize("T_,N_", [(60000, 27), (20000, 200), (3, 60000)])
def test_crt_twin_over_many_chunks(gen, T_, N_):
    """Both forms equal the twin bit for bit where each warp walks several
    chunks of 128 elements (more chunks than 8 warps a block times the
    blocks resident on the card), so the column advance between chunks is
    held draw for draw; and at N > 49152, where the sums form adds each
    count straight to the output in place of a shared column table."""
    y, r = _crt_inputs(T_, N_, T_ + N_)
    want = crt_sample_twin(y, r, 16, 2 ** 41 + 5, 3)
    yc, rc = torch.from_numpy(y).cuda(), torch.from_numpy(r).cuda()
    for yy in (yc, yc.float()):
        np.testing.assert_array_equal(
            crt_sample_cuda(yy, rc, 16, 2 ** 41 + 5, 3).cpu().numpy(), want)
        np.testing.assert_array_equal(
            crt_sample_sums_cuda(yy, rc, 16, 2 ** 41 + 5, 3).cpu().numpy(),
            want.sum(0, dtype=np.int64))


def test_crt_row_slabs_on_card(gen, monkeypatch):
    """Past K5's 32-bit element index the public wrappers launch once per
    slab of rows: the sums form's slabs then equal the per-element form's
    counts summed, from the same generator state."""
    from pyglm_tpu_torch.ops import linalg
    monkeypatch.setattr(linalg, "_K5_MAX_NUMEL", 27 * 40)
    y, r = _crt_inputs(301, 27, 2)
    yc, rc = torch.from_numpy(y).cuda(), torch.from_numpy(r).cuda()
    _build.reset_launches()
    l = linalg.crt_sample(yc, rc, 16, torch.Generator().manual_seed(4))
    s = linalg.crt_sample_sums(yc, rc, 16, torch.Generator().manual_seed(4))
    assert _build.LAUNCHES["crt_sample"] == 8
    assert _build.LAUNCHES["crt_sample_sums"] == 8
    assert l.shape == (301, 27) and torch.equal(s, l.sum(0))


def test_crt_wrappers_raise_on_bad_input(gen):
    y = torch.ones((8, 4), dtype=torch.int32, device="cuda")
    r = torch.ones(4, device="cuda")
    for fn in (crt_sample_cuda, crt_sample_sums_cuda):
        with pytest.raises(TypeError):
            fn(y.double(), r, 4, 0, 0)
        with pytest.raises(TypeError):
            fn(y, r.double(), 4, 0, 0)
        with pytest.raises(ValueError):
            fn(y.T, r, 4, 0, 0)                  # not contiguous
        with pytest.raises(ValueError):
            fn(y, r[:3].contiguous(), 4, 0, 0)
        with pytest.raises(ValueError):
            fn(y, r, -1, 0, 0)
        with pytest.raises(ValueError):
            fn(y, r, 4, -1, 0)
        with pytest.raises(ValueError):
            fn(y.cpu(), r.cpu(), 4, 0, 0)


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
                               "ss_group_pass_bf16": 0, "ss_group_pass_sr": 0,
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 3,
                               "crt_sample": 0, "crt_sample_sums": 0,
                               "group_gram": 0, "group_gram_bf16": 0}
    assert np.isfinite(m.log_likelihood())
    r = m.state.aux["r"]
    assert r.is_cuda and torch.all(r > 0)
    aux = m.observation.resample_aux(m.generators.host, m.state.aux,
                                     m.datas[0].Y, m.datas[0].Xf @ torch.zeros(
                                         (m.P, 16), device="cuda"))
    assert (_build.LAUNCHES["crt_sample_sums"] == 1
            and _build.LAUNCHES["crt_sample"] == 0 and torch.all(aux["r"] > 0))


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


@pytest.mark.parametrize("precision", ["high", "highest", "default"])
@pytest.mark.parametrize("T,N_pre,B,G,lanes", [(3001, 12, 4, 3, 70),
                                               (20_000, 20, 4, 10, 300),
                                               (2000, 14, 4, 7, 130),
                                               (2000, 32, 4, 16, 300),
                                               (1000, 3, 4, 1, 200),
                                               (40, 12, 4, 3, 130),
                                               (3001, 8, 4, 4, 4001),
                                               (20_000, 20, 4, 10, 250)])
def test_group_gram_kernel_matches_plain(gen, T, N_pre, B, G, lanes,
                                         precision):
    """K6 (3xTF32 on wgmma at "high", fp32 FMA at "highest", one bf16 pass
    on wgmma at "default") against its plain version: a ragged T with GB = 12, the
    ensemble's GB = 40 over three lane tiles, GB = 28 (not a multiple of
    8) over two; GB = 64 (2080 pairs, 13 pair tiles of the "default"
    body), GB = 4 (one partial tile), T = 40 (less than one 64-step
    stage), 4001 lanes (ragged against both 8 and 128), and 250 lanes
    over two groups, a second lane tile of 50 for the fp32 body's 80 x 200
    tiles and its T split in 6. The design holds continuous values, so
    the bf16 rounding of Z shows."""
    Xt = torch.rand((N_pre * B + 1, T), generator=gen, device="cuda") * (
        torch.rand((N_pre * B + 1, T), generator=gen, device="cuda") < 0.3)
    om = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen, device="cuda")
    k = group_gram_blocks_cuda(Xt, om, B, G, precision=precision)
    p = group_gram_blocks_plain(Xt, om, B, G, precision=precision)
    assert k.shape == p.shape == (N_pre // G, G * B * (G * B + 1) // 2,
                                  lanes)
    assert _rel(k, p) <= 1e-5
    assert torch.equal(k, group_gram_blocks_cuda(Xt, om, B, G,
                                                 precision=precision))
    with pytest.raises(ValueError):
        group_gram_blocks_cuda(Xt, om.double(), B, G, precision=precision)


def test_wgmma_probe_matches_torch_mm(gen):
    """The "default" body's wgmma tile machinery on known tiles: one
    warpgroup, 4 k-steps of m64n168k16 on a lane-major (transposed) A and
    a K-major B in the 128-byte-swizzled layouts, against torch.mm. Small
    integers make every sum exact, so the result must be equal."""
    from pyglm_tpu_torch.ops.gram_cuda import PAIR_TILE, wgmma_probe
    for _ in range(3):
        a = torch.randint(-3, 4, (64, 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        b = torch.randint(-3, 4, (PAIR_TILE, 64), generator=gen,
                          device="cuda").to(torch.bfloat16)
        d = wgmma_probe(a, b)
        assert torch.equal(d, a.float().T @ b.float().T)


def test_wgmma_tf32_probe_matches_the_split_product(gen):
    """The "high" body's tile machinery on known tiles: one warpgroup, one
    32-step stage of m64n120k8 TF32 products, A (omega) split into TF32 hi
    and lo in registers, B as K-major Z_hi and Z_lo tiles in the 128-byte
    swizzle. Values +-{1, 2, 3} + {-1, 0, 1} 2^-12 split into an integer
    hi and a lo of 2^-12, so every sum is exact: the result must equal the
    3xTF32 product of the splits (lo lo dropped). An identity B returns
    A's steps as the columns, which checks the A fragment map alone."""
    from pyglm_tpu_torch.ops.gram_cuda import (
        TF32_PAIR_TILE, tf32_split, wgmma_tf32_probe)

    def tile(shape):
        ints = torch.randint(1, 4, shape, generator=gen, device="cuda") * (
            2 * torch.randint(0, 2, shape, generator=gen, device="cuda") - 1)
        frac = torch.randint(-1, 2, shape, generator=gen, device="cuda")
        return (ints + frac * 2.0 ** -12).float().contiguous()
    for _ in range(3):
        a, b = tile((32, 64)), tile((TF32_PAIR_TILE, 32))
        (ah, al), (bh, bl) = (
            tuple(x.double() for x in tf32_split(t)) for t in (a, b))
        assert float(al.abs().max()) > 0 and float(bl.abs().max()) > 0
        want = al.T @ bh.T + ah.T @ bl.T + ah.T @ bh.T
        assert torch.equal(wgmma_tf32_probe(a, b).double(), want)
    a = (torch.arange(32, device="cuda")[:, None] * 64
         + torch.arange(64, device="cuda")).float().contiguous()
    b = torch.zeros((TF32_PAIR_TILE, 32), device="cuda")
    b[torch.arange(32), torch.arange(32)] = 1.0
    assert torch.equal(wgmma_tf32_probe(a, b), a.T @ b.T)


def test_group_gram_error_against_float64(gen):
    """At config 5's shapes and inputs for one group (GB = 40, T = 2e4,
    4000 lanes, spikes at rate 0.35), each K6 body is no further from a
    float64 Gram of its operands (rounded to bf16 at "default") than 2x its
    plain version: "high" (3xTF32 on wgmma), "highest" (fp32 FMA, folded
    every 512 steps) and "default" (one bf16 pass)."""
    T, B, G, lanes = 20_000, 4, 10, 4000
    Xt = _design(gen, G, T, rate=0.35)
    om = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen, device="cuda")
    p, q = pair_index(G * B, "cuda")
    X = Xt[:G * B]
    errs = {}
    for prec in ("high", "highest", "default"):
        k = group_gram_blocks_cuda(Xt, om, B, G, precision=prec)[0]
        plain = group_gram_blocks_plain(Xt, om, B, G, precision=prec)[0]
        if prec == "default":
            j64 = to_bf16(X[p] * X[q]).double() @ to_bf16(om).double()
            errs[prec] = (_rel(k.double(), j64), _rel(plain.double(), j64))
        else:
            errs[prec] = _f64_errors(k, plain, X, om, p, q)
    print(errs)
    for prec, (ek, ep) in errs.items():
        assert ek <= 2 * ep, (prec, errs)


def test_group_gram_highest_at_the_flagship_groups(gen):
    """K6's fp32 body at the flagship's shape (GB = 32, T = 1e5, 200
    lanes; two groups here, whose plan splits T in 18, as the 25 groups'
    plan splits it in 3, the partials summed by a second pass): within
    1e-5 of its plain version, no further from a float64 Gram than 2x the
    plain version, bit-repeatable."""
    from pyglm_tpu_torch.ops.gram_cuda import fp32_split_plan
    T, B, G, lanes = 100_000, 4, 8, 200
    assert fp32_split_plan(G * B, lanes, T, 2)[0] > 1
    Xt = _design(gen, 2 * G, T)
    om = 0.05 + 0.2 * torch.rand((T, lanes), generator=gen, device="cuda")
    k = group_gram_blocks_cuda(Xt, om, B, G, precision="highest")
    plain = group_gram_blocks_plain(Xt, om, B, G, precision="highest")
    assert _rel(k, plain) <= 1e-5
    assert torch.equal(k, group_gram_blocks_cuda(Xt, om, B, G,
                                                 precision="highest"))
    p, q = pair_index(G * B, "cuda")
    for g in range(2):
        ek, ep = _f64_errors(k[g], plain[g], Xt[g * G * B:(g + 1) * G * B],
                             om, p, q)
        assert ek <= 2 * ep, (g, ek, ep)


def test_highest_sweep_launches_k6_not_k2(gen):
    """precision="highest" runs the staged loop on K6's fp32 body at any T;
    K2 is never launched."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    Y = SparseBernoulliGLM(16, seed=1, device="cuda").generate(2000,
                                                                keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, precision="highest",
                           device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert weights.LAST_SS_PATH == "staged"
    assert _build.LAUNCHES == {"pg_devroye": 3, "ss_group_pass": 0,
                               "ss_group_pass_bf16": 0, "ss_group_pass_sr": 0,
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 0,
                               "crt_sample": 0, "crt_sample_sums": 0,
                               "group_gram": 3, "group_gram_bf16": 0}
    assert np.isfinite(m.log_likelihood())


@pytest.mark.parametrize("precision,key", [("default", "group_gram_bf16"),
                                           ("sr", "group_gram"),
                                           ("high", "group_gram")])
def test_staged_path_runs_the_k6_body_of_its_precision(gen, precision, key):
    """T < 384 routes the sweep to the staged loop: K6's bf16 body at
    "default", its "high" body at "sr" (as the JAX package runs it) and at
    "high"; K2 never."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    Y = SparseBernoulliGLM(16, seed=1, device="cuda").generate(300,
                                                                keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, precision=precision,
                           device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert weights.LAST_SS_PATH == "staged"
    want = {k: 0 for k in _build.LAUNCHES}
    want.update(pg_devroye=3, ss_edge_scan=3 * 4, **{key: 3})
    assert _build.LAUNCHES == want
    assert np.isfinite(m.log_likelihood())


def test_staged_path_launches_k6_not_k2(gen):
    """T < 384 routes the sweep to the staged loop: K6 once per sweep, K3
    per group, K2 never."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    Y = SparseBernoulliGLM(16, seed=1, device="cuda").generate(300,
                                                                keep=False)
    m = SparseBernoulliGLM(16, seed=2, group=4, device="cuda")
    m.add_data(Y)
    _build.reset_launches()
    m.fit(n_samples=3)
    assert weights.LAST_SS_PATH == "staged"
    assert _build.LAUNCHES == {"pg_devroye": 3, "ss_group_pass": 0,
                               "ss_group_pass_bf16": 0, "ss_group_pass_sr": 0,
                               "ss_edge_scan": 3 * 4, "pg_gamma_series": 0,
                               "crt_sample": 0, "crt_sample_sums": 0,
                               "group_gram": 3, "group_gram_bf16": 0}
    assert np.isfinite(m.log_likelihood())


@pytest.mark.parametrize("T,path", [(300, "staged"), (2000, "fused")])
def test_update_unchanged_with_tf32_on_globally(gen, T, path):
    """The sweep pins its float32 GEMMs (psi = Xf w, the staged loop's M0
    and scatter, the priors' einsums) to full float32 whatever the caller
    set: with TF32 switched on globally, a sweep at "high" from the same
    state and generators gives A identical and W, b equal to the sweep with
    it off, on the staged (T = 300) and on the fused loop, and leaves the
    caller's flag on."""
    from pyglm_tpu_torch import SparseBernoulliGLM
    from pyglm_tpu_torch.models import weights
    from pyglm_tpu_torch.models.ensemble import chain_generators
    Y = SparseBernoulliGLM(20, seed=1, device="cuda").generate(T, keep=False)
    m = SparseBernoulliGLM(20, seed=2, group=4, device="cuda")
    m.add_data(Y)
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            st, _ = m._sweep(chain_generators(9, "cuda"), m.state,
                             tuple(m.datas))
            assert weights.LAST_SS_PATH == path
            assert torch.backends.cuda.matmul.allow_tf32 == tf32
            outs.append(st)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    off, on = outs
    assert torch.equal(off.A, on.A)
    assert torch.equal(off.W, on.W) and torch.equal(off.b, on.b)


def test_latent_distance_hmc_on_card_matches_cpu(gen):
    """One batched LD resample (C = 2 chains, N = 50) on the card and on
    the CPU with the same injected noise: the same accepts, L and gamma
    within 1e-4."""
    from pyglm_tpu_torch.models.networks import (
        HMCNoise, LatentDistanceConfig, LatentDistanceState)
    from pyglm_tpu_torch.models.sweep import Generators
    C, N, B = 2, 50, 4
    cfg = LatentDistanceConfig(N=N, B=B, hmc_eps=0.03, swap_moves=10,
                               relocate_moves=10)
    g = torch.Generator().manual_seed(5)
    L = 0.8 * torch.randn((C, N, 2), generator=g)
    gamma = torch.tensor([0.3, -0.2])
    p = torch.sigmoid(cfg._logit_rho(L, gamma))
    A = (torch.rand((C, N, N), generator=g) < p).float()
    W = torch.randn((C, N, N, B), generator=g) * A[..., None]
    noise = cfg.draw_noise(g, C, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        st = LatentDistanceState(L.to(dev), gamma.to(dev),
                                 torch.zeros(C, B), torch.eye(B).repeat(C, 1,
                                                                      1),
                                 torch.zeros(C, device=dev))
        gens = Generators(torch.Generator(device=dev),
                          torch.Generator().manual_seed(1))
        outs[dev] = cfg.resample(gens, st, A.to(dev), W.to(dev),
                                 noise=HMCNoise(*(x.to(dev) for x in noise)))
    h, c = outs["cpu"], outs["cuda"]
    # Counts: the card divides by a scalar through its reciprocal.
    assert torch.equal((h.hmc_accept * 10).round(),
                       (c.hmc_accept.cpu() * 10).round())
    assert float((h.L - c.L.cpu()).abs().max()) <= 1e-4
    assert float((h.gamma - c.gamma.cpu()).abs().max()) <= 1e-4
    assert c.L.is_cuda and torch.isfinite(c.Sigma).all()


# ---------------------------------------------------------------------------
# The sharded port on the card (parallel/sharding.py): ranks on cuda:0
# ---------------------------------------------------------------------------

def _spawn_on_card(fn, world, backend):
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pyglm_tpu_torch.parallel.sharding import spawn
    return spawn(fn, world, backend=backend, device="cuda:0",
                 timeout_s=300)


@pytest.fixture(scope="module")
def gloo_updates():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_workers as wk
    return _spawn_on_card(wk.cuda_update_rank, 2, "gloo")


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("path", ["fused", "staged"])
def test_mesh_update_on_the_card_equals_unsharded(gloo_updates, shape,
                                                  path):
    """Two gloo ranks on cuda:0 (N=20, T=3000): the mesh update (K2 + K3,
    or K6 + K3) gives the unsharded update's A and w within 1e-4; on
    (1, 2), with no time split, exactly the unsharded update on the
    rank's lanes alone."""
    for r in gloo_updates:
        u = r[shape, path]
        assert u["path"] == "mesh_" + path
        assert u["A_equal"] and u["w_err"] <= 1e-4, u
        if shape[0] == 1:
            assert u["block_equal"], u
        L_ = u["launches"]
        if path == "fused":
            assert L_["ss_group_pass"] == 3 and L_["group_gram"] == 0
        else:
            assert L_["group_gram"] == 1 and L_["ss_group_pass"] == 0
        assert L_["ss_edge_scan"] == 2


def test_one_rank_nccl_mesh_runs_the_sharded_sweep():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_workers as wk
    r = _spawn_on_card(wk.cuda_nccl_rank, 1, "nccl")[0]
    assert r["backend"] == "nccl" and r["collectives"]["nccl"] > 0
    assert r["path"] == "mesh_fused" and np.all(np.isfinite(r["lls"]))
