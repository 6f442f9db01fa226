"""K2 at "default" and "sr" reads omega only as its bf16 stream, on the CPU.

The TPU kernel rounds omega to bf16 once at these modes and streams that
one array to the scatter, sum_t omega, the Gram and the u0 it starts from
(``pyglm_tpu/ops/ss_pallas.py:400-413``). The port does the same: the
fused loop makes ``omega_bf16_stream(omega)`` once per update, forms
u0 = kappa - omega16 * psi from it, and hands K2 the stream alone. These
tests hold that contract, at a shape where the stream's row stride N8 = 16
differs from N = 13, bit for bit against the earlier formulation, in which
K2's scatter and sum read a float32 tensor of the rounded values:

- ``ss_group_pass_plain`` and ``ss_group_pass`` given only the stream
  return u, M0, the packed Gram and sum_t omega equal to the earlier call on
  the float32 ``to_bf16(omega)``, in a middle group and in the epilogue;
- ``resample_spike_slab_tspace`` on the fused loop, with its noise fixed,
  returns A, w, u and sum_omega equal to the earlier loop computed here
  (u0 = kappa - to_bf16(omega) * psi, the earlier K2 on that tensor, K3 and
  the bias draw on the float32 omega).
"""
import numpy as np
import pytest
import torch

from pyglm_tpu_torch.models import weights as tw
from pyglm_tpu_torch.ops.ss_cuda import (
    omega_bf16_stream, pair_index, sr_round, sr_words, ss_edge_scan,
    ss_group_pass, ss_group_pass_plain, to_bf16)

torch.set_num_threads(1)

GB, T, N = 8, 1000, 13


def _earlier_k2(xp, xg, om_k, u, dw, want_sum_omega, precision, r16):
    """K2's plain version as it read omega before: the float32 om_k (the
    bf16 values) in the scatter and the sum, bf16(om_k) in the Gram."""
    if xp is not None:
        u -= om_k * (xp.T @ dw)
    if xg is None:
        return None, None, None
    m0 = xg @ u
    p, q = pair_index(xg.shape[0])
    Z = xg[p] * xg[q]
    Zr = to_bf16(Z) if precision == "default" else sr_round(Z, r16)
    return m0, Zr @ to_bf16(om_k), (om_k.sum(0) if want_sum_omega else None)


def _k2_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))
    xp, xg = f(GB, T), f(GB, T) * (f(GB, T) < 0.5)
    omega = 0.05 + 0.3 * f(T, N)
    return xp, xg, omega, f(T, N) - 0.5, 0.1 * (f(GB, N) - 0.5)


@pytest.mark.parametrize("call", ["plain", "dispatch"])
@pytest.mark.parametrize("precision", ["default", "sr"])
def test_k2_on_the_stream_alone_equals_the_float32_rounded_omega(precision,
                                                                 call):
    xp, xg, omega, u0, dw = _k2_inputs(1)
    om_k, om16 = to_bf16(omega), omega_bf16_stream(omega)
    assert om16.shape == (T, 16) and om16.dtype == torch.bfloat16
    sr_seed = (11, 3)
    r16 = (sr_words(*sr_seed, GB * (GB + 1) // 2, T)
           if precision == "sr" else None)

    def new(xp_, xg_, u_, want):
        if call == "plain":
            return ss_group_pass_plain(xp_, xg_, None, u_, dw, want,
                                       precision, r16, om16=om16)
        return ss_group_pass(xp_, xg_, None, u_, dw, want, precision,
                             sr_seed, om16=om16)
    u_new, u_old = u0.clone(), u0.clone()
    got = new(xp, xg, u_new, True)
    want = _earlier_k2(xp, xg, om_k, u_old, dw, True, precision, r16)
    assert torch.equal(u_new, u_old)
    for name, a, b in zip(("M0", "Jgg", "sum_omega"), got, want):
        assert torch.equal(a, b), name
    u_mid = u_old.clone()
    # The epilogue: the scatter alone, on the stream.
    assert new(xg, None, u_new, False) == (None, None, None)
    _earlier_k2(xg, None, om_k, u_old, dw, False, precision, r16)
    assert torch.equal(u_new, u_old)
    # Given the float32 omega instead, K2 makes the stream itself.
    u_f = u0.clone()
    got_f = ss_group_pass(xp, xg, omega, u_f, dw, True, precision, sr_seed)
    assert torch.equal(u_f, u_mid)
    for a, b in zip(got_f, want):
        assert torch.equal(a, b)


def _problem(seed, N_pre=8, B=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))
    P = N_pre * B + 1
    Xt = f(P, T) * (f(P, T) < 0.3)
    Xt[-1] = 1.0
    omega = 0.05 + 0.3 * f(T, N)
    kappa = (f(T, N) < 0.2).float() - 0.5
    psi = 2.0 * f(T, N) - 2.5
    w_full = 0.3 * (f(P, N) - 0.5) * (f(P, N) < 0.4)
    M = torch.from_numpy(rng.standard_normal((N_pre, N, B, B)).astype(
        np.float32))
    hyp = tw.EdgeHypers(
        mu=0.1 * (f(N_pre, N, B) - 0.5),
        Lam=M @ M.transpose(-1, -2) / B + torch.eye(B),
        logit_rho=torch.full((N_pre, N), -1.0),
        mu_b=torch.full((N,), -1.0), lam_b=torch.ones(N))
    return Xt, omega, kappa, psi, w_full, hyp


def _noise(seed, Ng, G, B, sr):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return tw.SpikeSlabNoise(
        u_a=t(rng.random((Ng, G, N))),
        eps=t(rng.standard_normal((Ng, G, N, B))),
        bias=t(rng.standard_normal(N)),
        sr=torch.from_numpy(rng.integers(0, 2 ** 62, (Ng, 2))) if sr
        else None)


def _earlier_fused(Xt, omega, kappa, psi, w_full, hyp, B, G, noise,
                   precision):
    """The fused update as it ran before: u0 and every K2 call on the
    float32 to_bf16(omega), the bias on the float32 omega."""
    P = w_full.shape[0]
    N_pre, GB = (P - 1) // B, G * B
    Ng = N_pre // G
    om_k = to_bf16(omega)
    u = kappa - om_k * psi
    w = w_full.clone()
    A = torch.empty((N_pre, N))
    dW = sum_om = None
    for g in range(Ng + 1):
        xp = Xt[(g - 1) * GB: g * GB] if g > 0 else None
        xg = Xt[g * GB:(g + 1) * GB] if g < Ng else None
        r16 = (sr_words(*noise.sr[g].tolist(), GB * (GB + 1) // 2, T)
               if precision == "sr" and xg is not None else None)
        m0, jgg, s = _earlier_k2(xp, xg, om_k, u, dW, g == 0, precision,
                                 r16)
        if g == 0:
            sum_om = s
        if g == Ng:
            break
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(jgg, m0, w[g * GB:(g + 1) * GB],
                                 hyp.mu[sl].contiguous(),
                                 hyp.Lam[sl].contiguous(),
                                 hyp.logit_rho[sl].contiguous(),
                                 noise.u_a[g].contiguous(),
                                 noise.eps[g].contiguous())
    b_old = w[P - 1].clone()
    m_b = u.sum(0) + sum_om * b_old + hyp.lam_b * hyp.mu_b
    lam_p = hyp.lam_b + sum_om
    b_new = m_b / lam_p + noise.bias / torch.sqrt(lam_p)
    u -= omega * (b_new - b_old)[None, :]
    w[P - 1] = b_new
    return A, w, u, sum_om


@pytest.mark.parametrize("precision", ["default", "sr"])
def test_fused_update_equals_the_earlier_formula(precision):
    B, G = 2, 4
    Xt, omega, kappa, psi, w_full, hyp = _problem(5, B=B)
    noise = _noise(6, 2, G, B, precision == "sr")
    got = tw.resample_spike_slab_tspace(
        torch.Generator().manual_seed(0), Xt, omega, kappa, psi, w_full, hyp,
        B, group=G, noise=noise, path="fused", precision=precision)
    assert tw.LAST_SS_PATH == "fused"
    want = _earlier_fused(Xt, omega, kappa, psi, w_full, hyp, B, G, noise,
                          precision)
    for name, a, b in zip(("A", "w", "u", "sum_omega"), got, want):
        assert torch.equal(a, b), name
    # Both edge states occur, so the comparison of A has teeth.
    assert 0 < int(got[0].sum()) < got[0].numel()
