"""Judge captured steps of the program against the float64 reference.

The reference follows the program one stage at a time from the program's
own state, since the stages are random draws: psi from the weights before
the step; the Polya-gamma draws against their exact moments under that
psi; the spike-and-slab update and the bias, from the program's omega and
its generator's noise; the network move from the program's new (A, W) and
its generators' states; for a tempered ladder, the swap from the rungs'
log-likelihoods and the program's uniforms. Each stage yields one or two
numbers, each held to a limit of its own (limits/<workload>.json).

  psi_gap     max |psi - psi_ref| / max |psi_ref|
  pg_z        max over lanes of |sum_t (omega - E omega)| / sd of that sum
  pg_z2       max over chains of |sum over the chain's lanes and bins of
              ((omega - E omega)^2 - Var omega)| / sd of that sum (from
              PG's fourth cumulant)
  pg_bad      omega draws that are not finite or not positive
  ss_a_lanes  lanes whose adjacency differs from the reference's
  ss_w_gap    over the other lanes, max |w - w_ref| / max |w_ref| a lane
              (weights and bias)
  net_gap     the network move's largest relative gap (rho, mu, Sigma;
              for the latent distance prior also l and gamma, at the
              nearest end state a float32 run can reach)
  swap_bad    rungs whose state after the swap is not the reference's
"""
from __future__ import annotations

import torch

from gibbsbench.reference import glm, networks
from gibbsbench.reference.design import design

F64 = torch.float64


def _rel(a, b) -> float:
    a, b = a.to(F64).cpu(), b.to(F64).cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _split(st, C):
    """The chains of a (possibly stacked) network state."""
    if C == 1 and st.mu.ndim == 1:
        return [st]
    return [type(st)(*(f[c] for f in st)) for c in range(C)]


def check_step(cfg: dict, cap: dict, Y, X=None) -> dict:
    """The numbers of one captured step (loops.System.capture)."""
    dev = Y.device
    B, G, N, C = cfg["B"], cfg["group"], cfg["N"], cap["chains"]
    prior, network = cfg["prior"], cfg["network"]
    if X is None:
        X = design(Y, B, cfg["L"])
    pre = cap["pre"]
    after = cap["swap"]["unswapped"] if cap["swap"] else cap["post"]
    lanes = C * N
    out = {}

    # psi from the weights before the step.
    w0 = glm.pack(pre.A, pre.W, pre.b).to(dev)
    psi = X @ w0
    out["psi_gap"] = _rel(cap["psi"], psi)

    # The Polya-gamma draws against their moments under psi.
    beta = torch.ones((lanes,), dtype=F64, device=dev)
    if cap["betas"] is not None:
        beta = torch.tensor(cap["betas"], dtype=torch.float32).to(
            dev, F64).repeat_interleave(N)
    omega = cap["omega"]
    m, v = glm.pg_moments(beta, psi)
    dev_om = omega.to(F64) - m
    del m
    z = dev_om.sum(0) / v.sum(0).sqrt()
    out["pg_z"] = float(z.abs().max())
    # By chain, not by lane: a lane's sum of squares can rest on a few
    # bins of high variance, and its tail is then far from normal.
    var2 = (glm.pg_cumulant4(beta, psi) + 2 * v * v).sum(0).reshape(C, N)
    z2 = ((dev_om.square_() - v).sum(0).reshape(C, N).sum(1)
          / var2.sum(1).sqrt())
    out["pg_z2"] = float(z2.abs().max())
    out["pg_bad"] = float((~torch.isfinite(omega) | (omega <= 0)).sum())
    del dev_om, v

    # The spike-and-slab update and the bias, from the program's omega.
    Yl = Y.to(F64).repeat(1, C)
    kappa = beta * (Yl - 0.5)
    states = _split(pre.net, C)
    hyp = networks.edge_hypers(prior, network, states, N, B, dev)
    noise = glm.replay_noise(cap["dev_gen"], dev, (N // G), G, lanes, B)
    A_ref, w_ref = glm.spike_slab(X, omega, kappa, psi, w0, hyp, B, G,
                                  noise)
    del kappa, Yl, psi
    A_prog = glm.unpack_A(after.A).to(dev)
    w_prog = glm.pack(after.A, after.W, after.b).to(dev)
    a_diff = (A_prog != A_ref).any(0)
    out["ss_a_lanes"] = float(a_diff.sum())
    keep = ~a_diff
    gaps = ((w_prog - w_ref).abs().max(0).values
            / w_ref.abs().max(0).values.clamp_min(1e-30))
    out["ss_w_gap"] = float(gaps[keep].max()) if keep.any() else 0.0

    # The network move, from the program's new (A, W).
    out["net_gap"] = _net_gap(cfg, cap, after, dev)

    if cap["swap"]:
        out["swap_bad"] = _swap_bad(cfg, cap, X, Y)
    return out


def _net_gap(cfg, cap, after, dev) -> float:
    prior, B, N, C = cfg["prior"], cfg["B"], cfg["N"], cap["chains"]
    calls = cap["net_calls"]
    post = _split(after.net, C)
    gaps = []
    if cfg["network"] == "erdos_renyi":
        for c, call in enumerate(calls):
            gaps.append(min(
                max(_rel(getattr(post[c], k), v) for k, v in ref.items())
                for ref in networks.er_resample(prior, call, B)))
        return max(gaps)
    call = calls[0]
    pre = _split(cap["pre"].net, C)
    A = call["A"].reshape(C, N, N).to(dev, F64)
    W = call["W"].reshape(C, N, N, B)
    mom_L, mom_g, u_hmc = networks.ld_noise(call["dev_gen"], dev, C, N,
                                            prior)
    state = call["host_gen"]
    for c in range(C):
        n_acc = round(float(post[c].hmc_accept) * prior["hmc_iters"])
        leaves = networks.hmc_leaves(
            prior, pre[c].L.to(dev, F64), pre[c].gamma.to(dev, F64), A[c],
            mom_L[c], mom_g[c], u_hmc[c], n_acc, cfg["check"]["hmc_delta"])
        gaps.append(min((max(_rel(post[c].L, L), _rel(post[c].gamma, gm))
                         for L, gm in leaves), default=float("inf")))
        # The chains draw in turn from one host generator: go on from the
        # state after the outcome nearest this chain's.
        gap, state = min(
            ((max(_rel(post[c].mu, mu), _rel(post[c].Sigma, Sigma)), st)
             for (mu, Sigma), st in networks.niw_draw(prior, state, W[c],
                                                      A[c], B)),
            key=lambda gs: gs[0])
        gaps.append(gap)
    return max(gaps)


def _swap_bad(cfg, cap, X, Y) -> float:
    """Rungs whose state after the swap differs from the unswapped state
    permuted by the reference's swap: lls in float64 from the unswapped
    weights, the parity bit and uniforms from the program's generator."""
    N, C = cfg["N"], cap["chains"]
    un, post = cap["swap"]["unswapped"], cap["post"]
    psi = X @ glm.pack(un.A, un.W, un.b).to(X.device)
    Yl = Y.to(F64).repeat(1, C)
    lls = (Yl * psi - torch.nn.functional.softplus(psi)).sum(0).reshape(
        C, N).sum(1).cpu()
    g = torch.Generator()
    g.set_state(cap["swap"]["host_gen"])
    parity = int(torch.randint(0, 2, (), generator=g))
    u = torch.rand((C,), generator=g).to(F64)
    betas = torch.tensor(cap["betas"], dtype=torch.float32).to(F64)
    perm = torch.arange(C)
    for i in range(parity, C - 1, 2):
        if torch.log(u[i]) < (betas[i + 1] - betas[i]) * (lls[i] - lls[i + 1]):
            perm[i], perm[i + 1] = i + 1, i
    bad = torch.zeros(C, dtype=torch.bool)
    for name in ("A", "W", "b"):
        a, b = getattr(post, name).cpu(), getattr(un, name).cpu()[perm]
        bad |= (a != b).reshape(C, -1).any(1)
    return float(bad.sum())


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit), ...]): every number at or under
    its limit; a number with no limit, or NaN, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = lim is not None and value == value and value <= lim
        ok &= good
        rows.append((name, value, lim))
    return ok, rows
