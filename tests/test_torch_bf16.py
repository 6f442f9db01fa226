"""The bf16 speed modes of pyglm_tpu_torch ("default": one bf16 pass;
"sr": one bf16 pass on a stochastically rounded Z) against the JAX package
on the CPU.

The Pallas kernels that run these modes execute only on a TPU
(tests/test_ss_fused.py), so the reference is the arithmetic of their
bodies, run by JAX on the CPU: ``ss_pallas._mm`` / ``gram_pallas._mm``
(a dot with float32 accumulation) on Z and omega cast to bf16 ("default"),
or on Z rounded by ``(bits + r16) & 0xFFFF0000`` ("sr", ``_sr16``'s rule,
written out here in numpy with the port's words).

- Gram: the plain K2 and K6 Grams against that arithmetic, max|diff| /
  max|ref| <= 1e-5 (products of bf16 values are exact in float32, so only
  the order of the float32 sums differs).
- The rounding: Philox4x32-10 against the Random123 known answers; the SR
  law as tests/test_ss_fused.py::test_stochastic_rounding_unbiased states
  it (neighbours only, bf16 values unchanged, unbiased at max |z| < 6 over
  512 roundings).
- The slice: the port's fused update at "default" / "sr" (JAX's noise and
  the same SR words injected) against JAX's ``_tspace_impl`` fed the same
  bf16-rounded omega and the same bf16 / SR Gram: A identical, w atol 1e-4,
  u atol 1e-3 after the bias scatter's difference is put back (the fused
  loop scatters the bias with the float32 omega, as the JAX fused kernel
  does; JAX's staged path here uses the omega it was given).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyglm_tpu_torch
from pyglm_tpu.models import weights as jw
from pyglm_tpu.ops import gram_pallas, ss_pallas
from pyglm_tpu.ops.basis import cosine_basis, design_matrix
from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops import gram_cuda, ss_cuda

torch.set_num_threads(1)
T, N, B, G = 1200, 12, 4, 4
NG, GB = N // G, G * B
NPAIR = GB * (GB + 1) // 2


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _bf16(x):
    """float32 numpy x rounded to bf16 (to nearest even), as float32."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


def _sr_np(x, r16):
    """The rounding of ss_pallas._sr16 with given words, in numpy."""
    return ((x.view(np.int32) + r16) & np.int32(-65536)).view(np.float32)


def _design(T_, n_pre, seed, rate=0.2):
    rng = np.random.default_rng(seed)
    Y = (rng.random((T_, n_pre)) < rate).astype(np.float32)
    return np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))


def _jax_gram(mm, Z, om):
    """The JAX body's Gram: mm(Z in bf16, omega in bf16), f32 accumulate."""
    return np.asarray(mm(jnp.asarray(Z).astype(jnp.bfloat16),
                         jnp.asarray(om).astype(jnp.bfloat16)))


@pytest.mark.parametrize("T_,n_pre,G_,lanes", [(700, 6, 3, 20),
                                               (1200, 8, 8, 130),
                                               (333, 10, 5, 7)])
def test_default_grams_match_jax_bf16_arithmetic(T_, n_pre, G_, lanes):
    """K2's and K6's plain "default" Grams against the JAX bodies' bf16
    arithmetic on the full GB x GB Z (ss_pallas.py:343-345,
    gram_pallas.py:47-60)."""
    Xf = _design(T_, n_pre, seed=T_)
    Xt = Xf.T.copy()
    rng = np.random.default_rng(lanes)
    om = (0.05 + 0.3 * rng.random((T_, lanes))).astype(np.float32)
    gb = G_ * B
    p, q = (x.numpy() for x in ss_cuda.pair_index(gb))
    k6 = gram_cuda.group_gram_blocks_plain(_t(Xt), _t(om), B, G_,
                                           precision="default").numpy()
    for g in range(n_pre // G_):
        xg = Xt[g * gb:(g + 1) * gb]
        Zfull = (xg[:, None, :] * xg[None, :, :]).reshape(gb * gb, T_)
        ref_fast = _jax_gram(gram_pallas._mm, Zfull, om).reshape(
            gb, gb, lanes)[p, q]
        ref_fused = _jax_gram(ss_pallas._mm, Zfull, om).reshape(
            gb, gb, lanes)[p, q]
        _, k2, _ = ss_cuda.ss_group_pass_plain(
            None, _t(xg), _t(om), torch.zeros((T_, lanes)), None,
            precision="default")
        scale = np.abs(ref_fast).max()
        assert np.abs(k6[g] - ref_fast).max() <= 1e-5 * scale
        assert np.abs(k2.numpy() - ref_fused).max() <= 1e-5 * scale
    # The bf16 Gram really differs from the float32 one at these inputs.
    f32 = gram_cuda.group_gram_blocks_plain(_t(Xt), _t(om), B, G_).numpy()
    assert np.abs(f32 - k6).max() > 1e-5 * np.abs(f32).max()


def test_philox_matches_known_answers():
    """Philox4x32-10 (the generator of K2's SR words) on the Random123
    known-answer vectors."""
    m = 0xFFFFFFFF
    for ctr, key, want in [
            ((0, 0, 0, 0), (0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((m, m, m, m), (m, m),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
             (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]:
        got = ss_cuda.philox4x32(ctr, key)
        assert tuple(int(x) for x in got) == want


def test_sr_words_layout():
    """Word t of row pr is 16-bit half t % 8 of the draw with counter
    (t // 8, pr, offset), key seed (low half first); a ragged T is cut."""
    seed, offset = (7 << 33) + 5, (3 << 32) + 11
    w = ss_cuda.sr_words(seed, offset, 3, 21).numpy()
    assert w.shape == (3, 21) and w.dtype == np.int32
    assert w.min() >= 0 and w.max() < 2 ** 16
    for pr, t in [(0, 0), (1, 9), (2, 20), (2, 7)]:
        d = ss_cuda.philox4x32(
            (t // 8, pr, offset & 0xFFFFFFFF, offset >> 32),
            (seed & 0xFFFFFFFF, seed >> 32))
        h = t % 8
        assert w[pr, t] == (int(d[h // 2]) >> (16 * (h % 2))) & 0xFFFF
    assert not np.array_equal(w, ss_cuda.sr_words(seed + 1, offset, 3,
                                                  21).numpy())


def test_stochastic_rounding_law():
    """sr_round with the words of 512 seeds: every output is one of the two
    bf16 neighbours, bf16 values pass unchanged, and the mean converges to
    the input (max |z| < 6 over 16k cells, a ~1e-5 family level)."""
    R = 512
    x = np.abs(np.random.RandomState(0).randn(64, 256)).astype(np.float32)
    x += 0.01
    x[0, :8] = [1.0, 0.5, 2.0, 0.75, 1.5, 3.0, 0.1875, 96.0]   # bf16 values
    xt = torch.from_numpy(x)
    out = np.stack([ss_cuda.sr_round(xt, ss_cuda.sr_words(s, 3, 64,
                                                           256)).numpy()
                    for s in range(R)])
    u = x.view(np.int32)
    flo = (u & -65536).view(np.float32)
    fhi = ((u & -65536) + 65536).view(np.float32)
    assert np.all((out >= flo[None]) & (out <= fhi[None]))
    exact = x == flo
    assert exact[0, :8].all()
    assert np.all(out[:, exact] == x[exact])
    se = np.maximum((fhi - flo) * 0.5 / np.sqrt(R), 1e-12)
    z = np.abs(out.mean(0) - x) / se
    assert float(z[~exact].max()) < 6.0, float(z[~exact].max())
    # The numpy rule of _sr16 gives the same values as the port's.
    r16 = ss_cuda.sr_words(9, 3, 64, 256)
    np.testing.assert_array_equal(ss_cuda.sr_round(xt, r16).numpy(),
                                  _sr_np(x, r16.numpy()))


def test_sr_gram_matches_jax_arithmetic():
    """K2's plain "sr" Gram against ss_pallas._mm on Z rounded by the same
    words and omega in bf16."""
    Xt = _design(T, 2 * G, seed=5).T.copy()
    om = (0.05 + 0.3 * np.random.default_rng(1).random((T, N))).astype(
        np.float32)
    xg = Xt[:GB]
    p, q = (x.numpy() for x in ss_cuda.pair_index(GB))
    r16 = ss_cuda.sr_words(21, 4, NPAIR, T)
    _, k2, _ = ss_cuda.ss_group_pass_plain(None, _t(xg), _t(om),
                                           torch.zeros((T, N)), None,
                                           precision="sr", r16=r16)
    Zsr = _sr_np(xg[p] * xg[q], r16.numpy())
    ref = _jax_gram(ss_pallas._mm, Zsr, om)
    assert np.abs(k2.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # The dispatcher draws those words from the (seed, offset) it is given.
    _, k2d, _ = ss_cuda.ss_group_pass(None, _t(xg), _t(om),
                                      torch.zeros((T, N)), None,
                                      precision="sr", sr_seed=(21, 4))
    assert torch.equal(k2d, k2)


def _problem(seed):
    rng = np.random.default_rng(seed)
    Y = (rng.random((T, N)) < 0.15).astype(np.float32)
    Xf = np.asarray(design_matrix(jnp.asarray(Y), cosine_basis(B, 10)))
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    W = (rng.standard_normal((N, N, B)) * A[..., None]).astype(np.float32)
    b = (-1.5 + 0.2 * rng.standard_normal(N)).astype(np.float32)
    w_full = np.asarray(jw.pack_weights(jnp.asarray(A), jnp.asarray(W),
                                        jnp.asarray(b)))
    M = rng.standard_normal((N, N, B, B))
    hyp = dict(mu=(0.1 * rng.standard_normal((N, N, B))).astype(np.float32),
               Lam=(M @ np.swapaxes(M, -1, -2) / B + np.eye(B)).astype(
                   np.float32),
               logit_rho=rng.normal(-1.0, 0.5, (N, N)).astype(np.float32),
               mu_b=np.full(N, -2.0, np.float32),
               lam_b=np.full(N, 1.0, np.float32))
    return dict(Xf=Xf, w_full=w_full, psi=(Xf @ w_full).astype(np.float32),
                omega=(0.05 + 0.2 * rng.random((T, N))).astype(np.float32),
                kappa=Y - 0.5, hyp=hyp,
                sr=rng.integers(0, 2 ** 62, (NG, 2)))


def _jax_noise(key):
    """The random numbers _tspace_impl's staged path draws from `key`."""
    keys = jax.random.split(key, NG + 1)
    u_a = np.zeros((NG, G, N), np.float32)
    eps = np.zeros((NG, G, N, B), np.float32)
    for g in range(NG):
        for i, gk in enumerate(jax.random.split(keys[g], G)):
            k1, k2 = jax.random.split(gk)
            u_a[g, i] = np.asarray(jax.random.uniform(k1, (N,)))
            eps[g, i] = np.asarray(jax.random.normal(k2, (N, B)))
    bias = np.asarray(jax.random.normal(keys[NG], (N,)))
    return tw.SpikeSlabNoise(_t(u_a), _t(eps), _t(bias))


def _fused_gram(Xt, om16, precision, sr):
    """The Gram the port's fused loop forms at `precision`, by the JAX
    body's arithmetic, in the JAX layout (Ng, N, GB, GB)."""
    p, q = (x.numpy() for x in ss_cuda.pair_index(GB))
    out = []
    for g in range(NG):
        xg = Xt[g * GB:(g + 1) * GB]
        Zp = xg[p] * xg[q]
        if precision == "sr":
            Zp = _sr_np(Zp, ss_cuda.sr_words(*(int(v) for v in sr[g]), NPAIR,
                                             T).numpy())
        full = np.zeros((GB, GB, T), np.float32)
        full[p, q] = Zp
        full[q, p] = Zp
        J = _jax_gram(ss_pallas._mm, full.reshape(GB * GB, T), om16)
        out.append(J.reshape(GB, GB, N).transpose(2, 0, 1))
    return jnp.asarray(np.stack(out))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("precision", ["default", "sr"])
def test_bf16_update_matches_jax(precision, seed):
    """The port's fused update at "default" / "sr" on the CPU against JAX's
    _tspace_impl given the same bf16-rounded omega and the same Gram (its
    staged path, the same noise): A identical, w atol 1e-4, u atol 1e-3
    (float32 sums over T in another order, as tests/test_torch_precision.py
    holds "high")."""
    p = _problem(seed)
    key = jax.random.key(500 + seed)
    om16 = _bf16(p["omega"])
    Xt = p["Xf"].T.copy()
    hj = jw.EdgeHypers(**{k: jnp.asarray(v) for k, v in p["hyp"].items()})
    A_j, w_j, u_j, s_j = jw.resample_spike_slab_tspace(
        key, jnp.asarray(p["Xf"]), jnp.asarray(om16),
        jnp.asarray(p["kappa"]), jnp.asarray(p["w_full"]), hj, B,
        precision="high", group=G, psi=jnp.asarray(p["psi"]),
        Jg=_fused_gram(Xt, om16, precision, p["sr"]), Xt=jnp.asarray(Xt))
    ht = tw.EdgeHypers(**{k: _t(v) for k, v in p["hyp"].items()})
    noise = _jax_noise(key)._replace(sr=torch.from_numpy(p["sr"]))
    A_t, w_t, u_t, s_t = tw.resample_spike_slab_tspace(
        None, _t(Xt), _t(p["omega"]), _t(p["kappa"]), _t(p["psi"]),
        _t(p["w_full"]), ht, B, group=G, noise=noise, precision=precision)
    assert tw.LAST_SS_PATH == "fused"
    np.testing.assert_array_equal(A_t.numpy(), np.asarray(A_j))
    assert 0 < A_t.sum() < N * N
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    # The fused loop's bias scatter took the float32 omega, JAX's staged
    # path the bf16 one: put the difference back before comparing u.
    db = w_t[-1].numpy() - p["w_full"][-1]
    u_same = u_t.numpy() + (p["omega"] - om16) * db[None, :]
    np.testing.assert_allclose(u_same, np.asarray(u_j), rtol=0, atol=1e-3)


def test_nb_model_at_default_runs_a_sweep():
    """The NB model at "default" rides the same fused loop (K4 + K2's bf16
    Gram + K3 on the card; their plain versions here)."""
    truth = pyglm_tpu_torch.SparseNegativeBinomialGLM(
        16, seed=1, obs_kwargs=dict(max_y=16), device="cpu")
    Y = np.minimum(truth.generate(1000, keep=False), 15)
    m = pyglm_tpu_torch.SparseNegativeBinomialGLM(
        16, seed=2, group=4, precision="default", obs_kwargs=dict(max_y=16),
        device="cpu")
    m.add_data(Y)
    diag = m.resample_model()
    assert tw.LAST_SS_PATH == "fused"
    assert np.isfinite(diag["log_likelihood"])
    assert bool((m.state.aux["r"] > 0).all())
