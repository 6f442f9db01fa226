"""pyglm_tpu_torch.ops.polyagamma: moments against the JAX package
(rtol 1e-6), the plain exact sampler by two-sample KS test against the JAX
sampler and against the native C++ oracle (n = 50k per c; gate p > 1e-3;
c = 3.0 and 3.25 straddle the switch from the tilted Levy to the
Michael-Schucany-Haas proposal at z t = 1, c = 3.125), sample means within
4 standard errors of pg_mean, and the float32 mixture weight against a
float64 one (1e-6 relative)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from pyglm_tpu.ops import polyagamma as jp
from pyglm_tpu_torch.ops import polyagamma as tp

torch.set_num_threads(1)
CS = [0.0, 0.5, 2.0, 3.0, 3.25, 8.0, 30.0]
N_DRAWS = 50_000
P_MIN = 1e-3


def _c_grid():
    rng = np.random.default_rng(0)
    return np.concatenate([[0.0, 1e-4, 1e-3, 0.5, 0.6, 0.61, 5.0, 40.0],
                           rng.normal(0, 6, 200)]).astype(np.float32)


@pytest.mark.parametrize("fn", ["pg_mean", "pg_var"])
@pytest.mark.parametrize("b", [1.0, 3.5])
def test_moments_match_jax(fn, b):
    """rtol 1e-6, except pg_var's exact branch at 0.6 <= |c| < 10: there
    2 tanh(c/2) - c (1 - tanh^2) cancels, and the one-ulp difference between
    XLA's and PyTorch's float32 tanh grows to ~3e-6 relative (both packages
    are ~1e-4 from the float64 value at |c| = 0.6). That band is held at
    rtol 4e-6."""
    c = _c_grid()
    got = getattr(tp, fn)(b, torch.from_numpy(c)).numpy()
    ref = np.asarray(getattr(jp, fn)(b, jnp.asarray(c)))
    band = ((np.abs(c) >= 0.6) & (np.abs(c) < 10.0) if fn == "pg_var"
            else np.zeros(c.shape, bool))
    np.testing.assert_allclose(got[~band], ref[~band], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[band], ref[band], rtol=4e-6, atol=0)


def _plain(c, seed, n=N_DRAWS):
    gen = torch.Generator().manual_seed(seed)
    return tp.pg_devroye_plain(torch.full((n,), c), gen).numpy()


@pytest.mark.parametrize("c", CS)
def test_plain_sampler_vs_jax_ks(c):
    ours = _plain(c, seed=int(c * 100) + 1)
    ref = np.asarray(jp.pg_devroye(jax.random.key(int(c * 100) + 2),
                                   jnp.full((N_DRAWS,), c, jnp.float32)))
    assert np.all(ours > 0)
    assert scipy.stats.ks_2samp(ours, ref).pvalue > P_MIN


@pytest.mark.parametrize("c", CS)
def test_plain_sampler_vs_native_oracle_ks(c):
    from pyglm_tpu_torch.native import native_available, pg_devroye_native
    if not native_available():
        pytest.skip("native PG oracle unavailable (no C++ toolchain)")
    ours = _plain(c, seed=int(c * 100) + 3)
    ref = pg_devroye_native(np.full(N_DRAWS, c), seed=int(c * 100) + 4,
                            n_threads=1)
    assert scipy.stats.ks_2samp(ours, ref).pvalue > P_MIN


@pytest.mark.parametrize("c", CS)
def test_plain_sampler_mean(c):
    x = _plain(c, seed=int(c * 100) + 5).astype(np.float64)
    m = float(tp.pg_mean(1.0, c))
    se = np.sqrt(float(tp.pg_var(1.0, c)) / x.size)
    assert abs(x.mean() - m) < 4 * se, (x.mean(), m, se)


def test_plain_sampler_keeps_shape_and_mixed_c():
    gen = torch.Generator().manual_seed(7)
    c = torch.from_numpy(_c_grid()).reshape(13, 16)
    x = tp.pg_devroye_plain(c, gen)
    assert x.shape == c.shape and x.dtype == torch.float32
    assert torch.isfinite(x).all() and (x > 0).all()


def test_pg_draw_unit_takes_plain_on_cpu_and_counts_no_launch():
    from pyglm_tpu_torch.ops import _build
    before = dict(_build.LAUNCHES)
    c = torch.linspace(-5, 5, 100)
    a = tp.pg_draw_unit(c, torch.Generator().manual_seed(3))
    b = tp.pg_devroye_plain(c, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _build.LAUNCHES == before


def test_pg_draw_unit_rejects_other_devices():
    with pytest.raises(ValueError):
        tp.pg_draw_unit(torch.zeros(4, device="meta"),
                        torch.Generator().manual_seed(0))


def test_cuda_wrapper_refuses_cpu_tensors():
    from pyglm_tpu_torch.ops.pg_cuda import pg_devroye_cuda
    with pytest.raises(ValueError):
        pg_devroye_cuda(torch.zeros(4), 0, 0)


def _weight64(z):
    """p / (p + q) in float64 and log space, by torch.special.log_ndtr."""
    z = z.double()
    t = 0.64
    K = np.pi ** 2 / 8.0 + 0.5 * z * z
    logp = torch.log(np.pi / (2.0 * K)) - K * t
    sqt = np.sqrt(t)
    logq = np.log(2.0) + torch.logaddexp(
        -z + torch.special.log_ndtr((z * t - 1.0) / sqt),
        z + torch.special.log_ndtr(-(z * t + 1.0) / sqt))
    return torch.exp(logp - torch.logaddexp(logp, logq))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.5), (1.5, 1.625), (1.625, 8.0),
                                   (8.0, 20.0), (20.0, 60.0)])
def test_mixture_weight_float32_vs_float64(lo, hi):
    """The float32 weight of the exponential branch (the formula K1 uses)
    within 1e-6 relative of the float64 weight wherever that is a normal
    float32; where it is not (z > ~18.5), both are below the smallest
    normal float32. The band (1.5, 1.625) holds the switch of Phi(a) at z =
    1/t = 1.5625, probed on both sides by the nearest float32 values."""
    z = torch.linspace(lo, hi, 20001, dtype=torch.float32)
    if lo <= 1.5625 <= hi:
        sw = torch.full((1,), 1.5625)
        z = torch.cat([z, torch.nextafter(sw, torch.zeros(1)), sw,
                       torch.nextafter(sw, torch.full((1,), 2.0))])
    w = tp.mixture_weight(z).double()
    ref = _weight64(z)
    tiny = float(torch.finfo(torch.float32).tiny)
    normal = ref >= tiny
    assert bool(torch.isfinite(w).all()) and bool((w >= 0).all())
    rel = ((w - ref).abs() / ref)[normal]
    assert rel.numel() == 0 or float(rel.max()) <= 1e-6, float(rel.max())
    if (~normal).any():
        assert float(w[~normal].max()) <= tiny * (1 + 1e-6)
