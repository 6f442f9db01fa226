"""Sufficient statistics and the conditionally Gaussian weight updates
(PyTorch counterpart of ``pyglm_tpu/models/weights.py``): the collapsed
spike-and-slab update in residual space, the dense update, and the
full-Gram spike-and-slab update that the JAX package keeps as a
cross-check of the residual-space one.

Weight layout: P = N*B + 1 design columns, presyn-major (column j*B + b =
presyn neuron j, basis b; last column = bias). w_full[:, n] stacks
A[j,n] * W[j,n,:] for all j, then b[n].

The update keeps the working residual u = kappa - omega * psi and visits
the presyn neurons in Ng groups of G, by one of two loops that draw the
same noise in the same order, so one generator gives the same chain up to
float rounding:

- "fused": per group g, kernel K2 (ops/ss_cuda.py) applies group g-1's
  weight change to u and forms the gather M0 = X_g u and the within-group
  Gram; kernel K3 then runs the collapsed Gibbs over the group's G edges for
  all postsyn lanes at once. The loop shape of the JAX package's mesh path
  (``_ss_fused_shard_map``) without the mesh.
- "staged": kernel K6 (ops/gram_cuda.py) forms every group's Gram in one
  launch; then per group M0 = X_g u (a GEMM), K3, and the scatter
  u -= omega * (X_g^T dW) (a GEMM and one elementwise pass). The JAX
  package's staged path (``_tspace_impl``).

:func:`ss_path` picks the loop where the JAX package's single-device
dispatcher picks it: the fused loop at precision "default", "sr" and
"high", never at "highest". The bias draw follows either.
"""
from __future__ import annotations

import operator
from typing import NamedTuple

import torch

from pyglm_tpu_torch.diagnostics.profiling import span
from pyglm_tpu_torch.ops.linalg import (
    chol_small, gaussian_evidence, logdet_from_chol, sample_from_evidence,
    sample_mvn_info, solve_lower_small, solve_lower_t_small,
)
from pyglm_tpu_torch.ops.gram_cuda import (
    group_gram_blocks_cuda, group_gram_blocks_plain,
)
from pyglm_tpu_torch.ops.ss_cuda import (
    _MAX_B, omega_bf16_stream, ss_edge_scan, ss_group_pass, unpack_gram,
)
from pyglm_tpu_torch.utils.utils import fp32_matmul, logistic

# The loop the last resample_spike_slab_tspace call ran: "fused" |
# "staged", or under a mesh "mesh_fused" | "mesh_staged".
LAST_SS_PATH = None


class EdgeHypers(NamedTuple):
    """Per-edge prior parameters handed from the network to the weights."""
    mu: torch.Tensor          # (N, N, B)    prior mean of W[pre, post]
    Lam: torch.Tensor         # (N, N, B, B) prior precision
    logit_rho: torch.Tensor   # (N, N)       prior log-odds of A[pre, post]
    mu_b: torch.Tensor        # (N,)         bias prior mean
    lam_b: torch.Tensor       # (N,)         bias prior precision


class SpikeSlabNoise(NamedTuple):
    """The random numbers of one spike-and-slab update, for callers that
    must reproduce a reference chain: per group g and edge i,
    ``a = u_a < p`` and ``w = mu_p + Lp^{-T} eps``; then the bias normal.
    At precision "sr" on the fused loop, `sr` holds each group's (seed,
    offset) of K2's rounding words (``ops/ss_cuda.py::sr_words``); when it
    is None they are drawn from the update's host generator."""
    u_a: torch.Tensor         # (Ng, G, N)
    eps: torch.Tensor         # (Ng, G, N, B)
    bias: torch.Tensor        # (N,)
    sr: torch.Tensor | None = None    # (Ng, 2) int64


def lane_hypers(hyp: EdgeHypers, lanes: slice) -> EdgeHypers:
    """The edge priors of a block of postsynaptic lanes."""
    return EdgeHypers(mu=hyp.mu[:, lanes], Lam=hyp.Lam[:, lanes],
                      logit_rho=hyp.logit_rho[:, lanes],
                      mu_b=hyp.mu_b[lanes], lam_b=hyp.lam_b[lanes])


def pack_weights(A, W, b):
    """(A, W, b) -> w_full (P, lanes) in the design-column layout (lanes:
    N, or a mesh rank's block of them)."""
    N, lanes, B = W.shape
    w = (A[:, :, None] * W).permute(0, 2, 1).reshape(N * B, lanes)
    return torch.cat([w, b[None, :]], dim=0)


def unpack_weights(w_full, N: int, B: int):
    """w_full (P, lanes) -> (W_eff (N, lanes, B), b (lanes,)) for N presyn
    neurons; W_eff is masked by A. The lanes are N, or a rank's block of
    them on a mesh."""
    W = w_full[: N * B].reshape(N, B, -1).permute(0, 2, 1)
    return W, w_full[N * B]


# Time steps per fp32 partial sum of the dense statistics (the default of
# the JAX package's t_chunk), and the bytes of omega-weighted design that
# one batch of chunks may hold.
T_CHUNK = 512
_CHUNK_BATCH_BYTES = 1 << 28


def check_t_chunk(t_chunk) -> int:
    """t_chunk as an int >= 1; ValueError otherwise."""
    try:
        n = operator.index(t_chunk)
    except TypeError:
        n = None
    if n is None or isinstance(t_chunk, bool) or n < 1:
        raise ValueError(f"t_chunk must be an integer >= 1, got {t_chunk!r}")
    return n


def _chunks(T: int, per_step: int, t_chunk: int = T_CHUNK):
    """(start, stop) of batches of whole t_chunk-step chunks, each batch's
    weighted design (per_step float32 a step) within _CHUNK_BATCH_BYTES."""
    n = max(1, _CHUNK_BATCH_BYTES // (4 * per_step * t_chunk)) * t_chunk
    return [(t0, min(t0 + n, T)) for t0 in range(0, T, n)]


def _chunked(x, t0, t1, t_chunk: int):
    """Rows t0 .. t1 of x (T, ...) as (chunks, t_chunk, ...), zero-padded."""
    xs = x[t0:t1]
    pad = -xs.shape[0] % t_chunk
    if pad:
        xs = torch.cat([xs, xs.new_zeros((pad,) + tuple(xs.shape[1:]))])
    return xs.reshape((-1, t_chunk) + tuple(xs.shape[1:]))


def _time_sum(x, mesh):
    """x summed over the mesh's time ranks (x itself without a mesh)."""
    if mesh is None:
        return x
    from pyglm_tpu_torch.parallel.sharding import all_reduce_sum
    return all_reduce_sum(x, mesh, "time")


@fp32_matmul()
def sufficient_stats(Xf, omega, kappa, t_chunk: int = T_CHUNK,
                     precision: str = "highest", mesh=None):
    """J[n] = Xf' diag(omega[:, n]) Xf and h[:, n] = Xf' kappa[:, n]: the
    dense update's statistics, O(N T P^2). Each `t_chunk`-step chunk is one
    fp32 batched GEMM (P x N P by the chunk's steps), and the chunks' sums
    add up, as the JAX package's scan does. `precision` (one of the four
    modes; ValueError otherwise) is the JAX package's parameter, and the
    GEMMs are full float32 at every mode, the port's rule for the dense J
    and h (the JAX package's einsum takes the mode's precision: one bf16
    pass at "default" on the TPU). Xf (T, P), omega and kappa (T, N);
    returns J (N, P, P), h (P, N). Under a `mesh` the rows are this time
    rank's and the lanes its own; J and h are summed over "time" (one
    all-reduce)."""
    check_precision(precision)
    t_chunk = check_t_chunk(t_chunk)
    T, P = Xf.shape
    N = omega.shape[1]
    J = Xf.new_zeros((N, P, P))
    for t0, t1 in _chunks(T, N * P, t_chunk):
        xc = _chunked(Xf, t0, t1, t_chunk)
        oc = _chunked(omega, t0, t1, t_chunk)
        xw = (oc[:, :, :, None] * xc[:, :, None, :]).reshape(
            xc.shape[0], t_chunk, N * P)                  # (c, tc, N P)
        J += torch.bmm(xw.transpose(1, 2), xc).sum(0).reshape(N, P, P)
    h = Xf.T @ kappa
    if mesh is None:
        return J, h
    Jh = _time_sum(torch.cat([J.reshape(-1), h.reshape(-1)]), mesh)
    return Jh[:J.numel()].reshape(J.shape), Jh[J.numel():].reshape(h.shape)


@fp32_matmul()
def diag_blocks(Xf, omega, B: int, t_chunk: int = T_CHUNK,
                precision: str = "highest"):
    """Jd[j, n] = X_j' diag(omega[:, n]) X_j for every presyn j and postsyn
    n, (N_pre, N, B, B): the only quadratic-in-basis statistic the collapsed
    edge scan needs, O(N^2 T B^2), chunked as :func:`sufficient_stats`
    (`t_chunk` steps a chunk; full float32 at every `precision`)."""
    check_precision(precision)
    t_chunk = check_t_chunk(t_chunk)
    T, P = Xf.shape
    N_pre, N = (P - 1) // B, omega.shape[1]
    acc = Xf.new_zeros((N_pre * B * B, N))
    for t0, t1 in _chunks(T, N_pre * B * B + N, t_chunk):
        xc = _chunked(Xf[:, :N_pre * B], t0, t1, t_chunk).reshape(
            -1, t_chunk, N_pre, B)
        Z = (xc[..., :, None] * xc[..., None, :]).reshape(
            xc.shape[0], t_chunk, N_pre * B * B)
        acc += torch.bmm(Z.transpose(1, 2),
                         _chunked(omega, t0, t1, t_chunk)).sum(0)
    return acc.reshape(N_pre, B, B, N).permute(0, 3, 1, 2)


def _block_diag_precision(Lam0, lam_b, P: int, B: int):
    """The (N_post, P, P) prior precisions: each postsyn lane's (N_pre, B, B)
    per-edge blocks on the diagonal, the bias precision last. Lam0 is
    (N_pre, N_post, B, B), lam_b (N_post,)."""
    N_pre, N = Lam0.shape[:2]
    full = Lam0.new_zeros((N, N_pre, B, N_pre, B))
    idx = torch.arange(N_pre, device=Lam0.device)
    full[:, idx, :, idx, :] = Lam0
    full = full.reshape(N, N_pre * B, N_pre * B)
    out = Lam0.new_zeros((N, P, P))
    out[:, :N_pre * B, :N_pre * B] = full
    out[:, P - 1, P - 1] = lam_b
    return out


def resample_dense(generator, J, h, hyp: EdgeHypers, B: int, eps=None):
    """The dense weight update (A == 1), every postsyn lane at once:
    w[:, n] ~ N((L0_n + J_n)^{-1} (h_n + L0_n mu0_n), (L0_n + J_n)^{-1}),
    one batched (P, P) Cholesky (the JAX package's vmapped
    ``_dense_one_neuron``). J (N, P, P), h (P, N); `eps` (N, P), the
    standard normals of the draw, or None to draw them from `generator`.
    Returns w_full (P, N)."""
    P, N = h.shape
    prec = _block_diag_precision(hyp.Lam, hyp.lam_b, P, B) + J
    h0 = torch.cat([torch.einsum("jnbc,jnc->njb", hyp.Lam,
                                 hyp.mu).reshape(N, -1),
                    (hyp.lam_b * hyp.mu_b)[:, None]], dim=1)      # (N, P)
    return sample_mvn_info(generator, h.T + h0, prec, eps=eps).T


def resample_spike_slab(generator, J, h, w_full, hyp: EdgeHypers, B: int,
                        noise: SpikeSlabNoise | None = None):
    """The full-Gram collapsed spike-and-slab update (the JAX package's
    ``resample_spike_slab``, its cross-check of the residual-space one):
    per presyn block j in order, for all postsyn lanes at once,
    m_j = h_j - (J w)_j + J_jj w_j, a_j ~ Bern(logistic(logit rho_j +
    log E_j)), w_j | a_j, with the running r = J w updated by the change;
    then the bias. J (N, P, P), h and w_full (P, N). `noise` holds the
    uniforms, normals and bias normal in :class:`SpikeSlabNoise`'s layout
    (any grouping: edge j is flat index j of the presyn axes), so that the
    residual-space update fed the same noise draws the same chain; None
    draws them from `generator` in that order. Returns (A (N_pre, N),
    w_full (P, N))."""
    P, N = h.shape
    N_pre = (P - 1) // B
    dev = h.device
    if noise is None:
        u_a = torch.rand((N_pre, N), generator=generator, device=dev)
        eps = torch.randn((N_pre, N, B), generator=generator, device=dev)
        z_b = torch.randn((N,), generator=generator, device=dev)
    else:
        u_a, eps = noise.u_a.reshape(N_pre, N), noise.eps.reshape(N_pre, N, B)
        z_b = noise.bias
    w = w_full.T.clone()                                   # (N, P)
    r = (J @ w[:, :, None])[..., 0]                        # (N, P)
    ht = h.T
    ld0 = 0.5 * logdet_from_chol(torch.linalg.cholesky(hyp.Lam))
    A = torch.empty((N_pre, N), dtype=h.dtype, device=dev)
    for j in range(N_pre):
        sl = slice(j * B, (j + 1) * B)
        Jjj = J[:, sl, sl]
        wj = w[:, sl].clone()
        m = ht[:, sl] - (r[:, sl] - (Jjj @ wj[:, :, None])[..., 0])
        ev = gaussian_evidence(m, Jjj, hyp.mu[j], hyp.Lam[j],
                               chol0_logdet=ld0[j])
        a = u_a[j] < logistic(hyp.logit_rho[j] + ev.log_evidence)
        wnew = torch.where(a[:, None], sample_from_evidence(None, ev,
                                                            eps=eps[j]),
                           torch.zeros_like(wj))
        r += (J[:, :, sl] @ (wnew - wj)[:, :, None])[..., 0]
        w[:, sl] = wnew
        A[j] = a.to(h.dtype)
    # The always-active bias column.
    m_b = ht[:, -1] - (r[:, -1] - J[:, -1, -1] * w[:, -1]) + hyp.lam_b * hyp.mu_b
    lamp = hyp.lam_b + J[:, -1, -1]
    w[:, -1] = m_b / lamp + z_b / torch.sqrt(lamp)
    return A, w.T.contiguous()


def _auto_group(N_pre: int, B: int = 4) -> int:
    """Divisor G of N_pre with G*B % 8 == 0 nearest to 8 (larger on ties),
    else the divisor nearest 5: the JAX package's choice on the TPU
    (G = 8 at N = 200, B = 4)."""
    divs = [g for g in range(1, min(16, N_pre) + 1) if N_pre % g == 0]
    aligned = [g for g in divs if (g * B) % 8 == 0]
    if aligned:
        return min(aligned, key=lambda g: (abs(g - 8), -g))
    return min(divs, key=lambda g: (abs(g - 5), -g))


def _batched_evidence(m, Jjj, mu0, Lam0, ld0_half):
    """Collapsed evidence of one presyn block across all postsyn lanes:
    m (N, B), Jjj (N, B, B), mu0 (N, B), Lam0 (N, B, B), ld0_half (N,).
    Returns (log_ev (N,), mu_p (N, B), Cp (N, B, B))."""
    Cp = chol_small(Lam0 + Jjj)
    bpost = m + torch.einsum("nbc,nc->nb", Lam0, mu0)
    z = solve_lower_small(Cp, bpost)
    quad_p = 0.5 * torch.sum(z * z, dim=-1)
    quad_0 = 0.5 * torch.einsum("nb,nbc,nc->n", mu0, Lam0, mu0)
    logdet_p = torch.log(torch.diagonal(Cp, dim1=-2, dim2=-1)).sum(-1)
    log_ev = quad_p - quad_0 + ld0_half - logdet_p
    return log_ev, solve_lower_t_small(Cp, z), Cp


def _group_edge_scan(Jgg, M0, wg, mu0g, Lam0g, ld0g, lrhog, u_a, eps):
    """Collapsed Gibbs over one group's G presyn blocks, all postsyn lanes
    at once (the plain arithmetic of kernel K3).

    Jgg (N, GB, GB); M0, wg (GB, N); mu0g (G, N, B); Lam0g (G, N, B, B);
    ld0g, lrhog, u_a (G, N); eps (G, N, B).
    Returns (dW = w_new - w_old (GB, N), wg_new (GB, N), a_g (G, N)).
    """
    G, N, B = mu0g.shape
    dW = torch.zeros_like(M0)
    w_cur = wg.clone()
    a_g = torch.empty((G, N), dtype=M0.dtype, device=M0.device)
    for i in range(G):
        li = i * B
        Jrow = Jgg[:, li:li + B, :]
        Jii = Jgg[:, li:li + B, li:li + B]
        wi = w_cur[li:li + B].clone()                       # (B, N)
        m = (M0[li:li + B].T - torch.einsum("nbq,qn->nb", Jrow, dW)
             + torch.einsum("nbc,cn->nb", Jii, wi))
        log_ev, mu_p, Cp = _batched_evidence(m, Jii, mu0g[i], Lam0g[i],
                                             ld0g[i])
        a = u_a[i] < logistic(lrhog[i] + log_ev)
        w_draw = mu_p + solve_lower_t_small(Cp, eps[i])
        w_new = torch.where(a[:, None], w_draw, torch.zeros_like(w_draw))
        dW[li:li + B] = w_new.T - wi
        w_cur[li:li + B] = w_new.T
        a_g[i] = a.to(M0.dtype)
    return dW, w_cur, a_g


# Scoped-vmem budget of the JAX package's monolithic fused TPU kernel
# (pyglm_tpu/models/weights.py); kept only so that ss_path routes a
# configuration as the JAX package does.
_FUSED_VMEM_CAP = int(15.5 * 2 ** 20)


def _fused_vmem_bytes(G: int, B: int, npad: int, tc: int) -> int:
    """The JAX package's estimate of its fused kernel's scoped-vmem stack
    (double-buffered streams and slabs plus the Gram-triangle scratch)."""
    GB = G * B
    G8 = -(-G // 8) * 8
    streams = 2 * 4 * (2 * GB * tc + 3 * tc * npad)
    slabs = 2 * 4 * npad * (3 * GB + G * B * B + 2 * G8 + 8)
    scratch = 4 * npad * (G * (G + 1) // 2 * B * B + 2 * GB)
    return streams + slabs + scratch


def _fused_plan(N_pre: int, B: int, npad: int, t_chunk: int,
                group: int | None = None):
    """(G, tc) of the JAX package's fused kernel, or None when no group
    fits its budget (npad around 4096 and wider)."""
    if group is not None:
        gs = [group]
    else:
        gs = sorted((g for g in range(1, min(16, N_pre) + 1)
                     if N_pre % g == 0 and (g * B) % 8 == 0),
                    key=lambda g: (abs(g - 8), -g))
    for g in gs:
        tc = max(t_chunk, 1024)
        while tc >= 128:
            if _fused_vmem_bytes(g, B, npad, tc) <= _FUSED_VMEM_CAP:
                return g, tc
            tc //= 2
    return None


# Precision modes, as in the JAX package. The spike-and-slab Gram on the
# card: "high" 3xTF32 (K2 in the fused loop, K6's "high" body in the staged
# loop); "default" one bf16 pass (K2's bf16 Gram, K6's bf16 body); "sr" one
# bf16 pass on a stochastically rounded Z in the fused loop (K2) and, as in
# the JAX package, the "high" Gram in the staged loop; "highest" the staged
# loop on K6's fp32 FMA body.
PRECISIONS = ("default", "sr", "high", "highest")


def check_precision(precision: str) -> None:
    """Raise for an unknown precision mode."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: one of {PRECISIONS}")


def ss_path(N_pre: int, B: int, lanes: int, T: int, group: int | None = None,
            jg_given: bool = False, precision: str = "highest") -> str:
    """"staged" or "fused": the loop the JAX package's single-device
    dispatcher (``_tspace_impl``) picks for this configuration, without its
    backend tests (TPU, device count, mesh, environment). The same
    configuration then runs the same algorithm in both packages; on the
    card both loops are hand-written kernels, so neither is a fallback and
    nothing warns. "highest" always runs the staged loop, as in the JAX
    package. Which loop is faster at wide lanes is measured in PERF.md."""
    check_precision(precision)
    plan = _fused_plan(N_pre, B, -(-lanes // 128) * 128, 512, group=group)
    if (precision == "highest" or jg_given or T < 384 or B > _MAX_B
            or plan is None or (plan[0] * B) % 8):
        return "staged"
    return "fused"


def group_gram_blocks(Xt, omega, B: int, G: int, packed: bool = True,
                      fast: bool = False, precision: str = "highest",
                      mesh=None):
    """Every group's omega-weighted Gram: kernel K6 for CUDA tensors, its
    plain version for CPU tensors. The body, as the JAX package picks its
    Pallas body: ``fast=True`` or precision "default" the single bf16 pass
    (``_gram_kernel_fast``), "high" and "sr" 3xTF32 (``_gram_kernel_f32``;
    the JAX package's "sr" takes it too), "highest" fp32 FMA (its f32 XLA
    Gram); on the CPU the bf16 body is the plain bf16 Gram and the others
    fp32. Xt (P, T) with the bias row last. Returns the packed
    (Ng, GB(GB+1)/2, N), or with ``packed=False`` the JAX package's
    (Ng, N, GB, GB). Under a `mesh` (the JAX package's ``_gram_shard_map``)
    Xt and omega hold this time rank's rows and its lanes: the rank forms
    its rows' Gram (K6 on the card) and the time ranks sum them."""
    check_precision(precision)
    body = ("default" if fast or precision == "default" else
            "highest" if precision == "highest" else "high")
    if Xt.shape[1] == 0:            # a time rank with no rows of its own
        GB = G * B
        Jg = omega.new_zeros(((Xt.shape[0] - 1) // GB, GB * (GB + 1) // 2,
                              omega.shape[1]))
    elif omega.is_cuda:
        Jg = group_gram_blocks_cuda(Xt, omega, B, G, precision=body)
    elif omega.device.type == "cpu":
        Jg = group_gram_blocks_plain(Xt, omega, B, G, precision=body)
    else:
        raise ValueError(f"group_gram_blocks: unsupported device "
                         f"{omega.device}")
    Jg = _time_sum(Jg, mesh)
    if packed:
        return Jg
    return torch.stack([unpack_gram(j, G * B) for j in Jg])


def _draw_group_noise(generator, noise, g, G, N, B, dev, shard=None):
    """Group g's (u_a (G, N), eps (G, N, B)): drawn, or taken from noise.
    On a mesh (`shard`) the noise is drawn at full width, as without a
    mesh, and the rank's lanes are returned."""
    if shard is not None:
        N = shard.n_lanes
    if noise is not None:
        u_a, eps = noise.u_a[g], noise.eps[g]
    else:
        u_a = torch.rand((G, N), generator=generator, device=dev)
        eps = torch.randn((G, N, B), generator=generator, device=dev)
    if shard is not None:
        u_a, eps = u_a[:, shard.lanes], eps[:, shard.lanes]
    return u_a.contiguous(), eps.contiguous()


def _sr_seeds(host_generator, noise, Ng):
    """The (Ng, 2) (seed, offset) pairs of K2's "sr" rounding words, one
    per group: ``noise.sr`` if given, else one draw from the host
    generator."""
    if noise is not None and noise.sr is not None:
        return noise.sr.tolist()
    if host_generator is None:
        raise ValueError("precision='sr' on the fused loop draws K2's "
                         "rounding seeds: pass host_generator or noise.sr")
    return torch.randint(0, 2 ** 62, (Ng, 2),
                         generator=host_generator).tolist()


def _fused_loop(generator, host_generator, Xt, omega, om16, u, w, hyp, A,
                G, B, noise, precision, shard=None):
    """Ng x (K2 + K3) and K2's epilogue, K2's Gram at `precision`; updates
    u, w and A in place and returns sum_t omega. At "high" K2 reads the
    float32 omega; at "default" and "sr" only `om16`, omega's bf16 stream,
    made once per update by the caller: every scatter, sum_t omega and
    Gram of the update's Ng + 1 K2 calls reads it. On a mesh (`shard`; the
    JAX package's ``_ss_fused_shard_map``) K2 runs on the rank's rows and
    lanes, and [M0; the packed Jgg] are summed over "time" in one
    all-reduce a group, in the layout K3 reads, before K3 runs on the
    rank's lanes, replicated across its time ranks; the sum returned is
    the rank's own."""
    N = u.shape[1]
    GB, Ng = G * B, A.shape[0] // G
    sr = _sr_seeds(host_generator, noise, Ng) if precision == "sr" else None
    if om16 is not None:
        omega = None                  # K2 reads the bf16 stream alone
    dW = sum_om = None
    for g in range(Ng + 1):
        xp = Xt[(g - 1) * GB: g * GB] if g > 0 else None
        xg = Xt[g * GB:(g + 1) * GB] if g < Ng else None
        sr_seed = tuple(sr[g]) if sr is not None and xg is not None else (0, 0)
        m0, jgg, s = ss_group_pass(xp, xg, omega, u, dW,
                                   want_sum_omega=(g == 0),
                                   precision=precision, sr_seed=sr_seed,
                                   om16=om16)
        if g == 0:
            sum_om = s
        if g == Ng:
            break
        if shard is not None:
            mj = _time_sum(torch.cat([m0, jgg]), shard.mesh)
            m0, jgg = mj[:GB], mj[GB:]
        u_a, eps = _draw_group_noise(generator, noise, g, G, N, B, u.device,
                                     shard)
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(jgg, m0, w[g * GB:(g + 1) * GB], hyp.mu[sl],
                                 hyp.Lam[sl], hyp.logit_rho[sl], u_a, eps)
    return sum_om


def _staged_loop(generator, Xt, omega, u, w, hyp, A, G, B, noise, precision,
                 Jg=None, shard=None):
    """K6 once (unless the packed Jg is given; the span "gram"), then per
    group M0 = X_g u, K3 on Jg[g] and the scatter u -= omega * (X_g^T dW);
    updates u, w and A in place and returns sum_t omega. On a mesh
    (`shard`) K6 runs on the rank's rows and its Gram, unless given (then
    summed already), and each M0 are summed over "time"; the sum returned
    is the rank's own."""
    N = omega.shape[1]
    GB = G * B
    mesh = None if shard is None else shard.mesh
    if Jg is None:
        with span("gram"):
            Jg = group_gram_blocks(Xt, omega, B, G, precision=precision,
                                   mesh=mesh)
    for g in range(Jg.shape[0]):
        xg = Xt[g * GB:(g + 1) * GB]
        m0 = _time_sum(xg @ u, mesh)
        u_a, eps = _draw_group_noise(generator, noise, g, G, N, B, u.device,
                                     shard)
        sl = slice(g * G, (g + 1) * G)
        dW, A[sl] = ss_edge_scan(Jg[g], m0, w[g * GB:(g + 1) * GB],
                                 hyp.mu[sl], hyp.Lam[sl], hyp.logit_rho[sl],
                                 u_a, eps)
        u.addcmul_(omega, xg.T @ dW, value=-1.0)
    return omega.sum(0)


def mesh_ss_path(precision: str = "highest", jg_given: bool = False,
                 whole_rows: bool = False) -> str:
    """The spike-and-slab loop on a mesh, as the JAX package's mesh
    dispatch picks it: "mesh_fused" (K2 + K3 per shard) unless the packed
    Gram is given (a Gaussian's cached Gram: "mesh_staged" on it), or a
    dataset keeps its whole rows on every time rank, or the precision is
    "highest" (K2 has no fp32 Gram; the JAX package's mesh path takes its
    f32 XLA Gram there). The last two run "mesh_staged" with a warning,
    never silently."""
    check_precision(precision)
    if jg_given:
        return "mesh_staged"
    reasons = []
    if whole_rows:
        reasons.append("a dataset's T is not divisible by the mesh time "
                       "axis (its whole rows sit on every time rank)")
    if precision == "highest":
        reasons.append("precision='highest' needs K6's fp32 Gram, and K2 "
                       "has none")
    if not reasons:
        return "mesh_fused"
    import warnings
    warnings.warn("mesh sweep runs the staged spike-and-slab loop (K6 + "
                  "K3) instead of the fused one: " + "; ".join(reasons),
                  stacklevel=3)
    return "mesh_staged"


def resample_spike_slab_tspace(generator: torch.Generator, Xt, omega, kappa,
                               psi, w_full, hyp: EdgeHypers, B: int,
                               group: int | None = None,
                               noise: SpikeSlabNoise | None = None,
                               path: str | None = None, Jg=None,
                               precision: str = "highest",
                               host_generator: torch.Generator | None = None,
                               mesh=None):
    """Collapsed spike-and-slab for all neurons in residual (T-) space.

    Args:
      generator: draws the update's noise on omega's device (unless
        `noise` is given).
      Xt: (P, T) transposed design; omega, kappa, psi: (T, N).
      w_full: (P, N) current packed weights; hyp: per-edge priors.
      group: presyn neurons per group (default :func:`_auto_group`).
      noise: the update's random numbers, to reproduce a reference chain.
      path: "fused" or "staged" to force a loop (default :func:`ss_path`).
      Jg: every group's packed Gram (:func:`group_gram_blocks`), to run the
        staged loop on it instead of forming it.
      precision: the Gram's mode, as in the JAX package. "high": 3xTF32
        on the card (K2 in the fused loop where :func:`ss_path` picks it,
        else K6's "high" body). "default": one bf16 pass (K2's bf16 Gram,
        K6's bf16 body). "sr": in the fused loop K2's bf16 pass on a
        stochastically rounded Z; in the staged loop the "high" Gram, as
        the JAX package runs it (the launch counts show which ran).
        "highest": the staged loop on K6's fp32 body (a forced "fused"
        raises). In the fused loop at "default" and "sr", omega is rounded
        once into its bf16 stream (``omega_bf16_stream``), which feeds u0
        and every K2 call's scatter, Gram and sum_omega (no float32 copy of
        the rounded omega is made), while the bias scatter takes the
        float32 omega, as the JAX fused kernel does
        (``weights.py:709-715``). On the CPU the plain versions
        repeat each mode's rounding; "high" and "highest" are fp32 there.
      host_generator: a CPU generator that draws, in one (Ng, 2) draw, the
        (seed, offset) of each K2 call's rounding words at "sr" in the
        fused loop (unless ``noise.sr`` is given); no other mode draws
        from it.

      mesh: a ("time", "neuron") or ("chain", "time", "neuron") mesh
        (parallel/sharding.py). Xt, omega, kappa and psi then hold this
        rank's rows and lanes, w_full and hyp its lanes; the Grams, M0 and
        the bias sums are summed over "time", and every draw (the noise,
        the bias normal, the "sr" seeds) comes at full width from the
        replicated `generator` and `host_generator`, each rank keeping its
        lanes: given the same omega and noise, every mesh gives the
        unsharded update's A and w but for the fp32 order of the time
        ranks' sums. `noise` is full width. `path`: "mesh_fused" or
        "mesh_staged" (default :func:`mesh_ss_path`).

    Returns (A (N_pre, N), w_full (P, N), u (T, N), sum_omega (N,)); psi
    under the new weights is (kappa - u) / omega. The loop run is recorded
    in ``LAST_SS_PATH``.
    """
    global LAST_SS_PATH
    T, N = omega.shape
    P = w_full.shape[0]
    N_pre = (P - 1) // B
    G = _auto_group(N_pre, B) if group is None else group
    if N_pre % G:
        raise ValueError(f"group={G} does not divide N_pre={N_pre}")
    check_precision(precision)
    shard = None
    if mesh is not None:
        from pyglm_tpu_torch.parallel.sharding import lane_count, lane_shard
        shard = lane_shard(mesh, N * lane_count(mesh))
        paths = ("mesh_fused", "mesh_staged")
        if path is None:
            path = mesh_ss_path(precision, jg_given=Jg is not None)
    else:
        paths = ("fused", "staged")
        if path is None:
            path = ss_path(N_pre, B, N, T, group=group,
                           jg_given=Jg is not None, precision=precision)
    fused, staged = paths
    if path not in paths or (Jg is not None and path != staged):
        raise ValueError(f"path={path!r}: {fused!r} or {staged!r} (a given "
                         f"Jg runs the staged loop)")
    if path == fused and precision == "highest":
        raise ValueError(f"path={fused!r} runs K2, whose Gram is not fp32; "
                         f"precision='highest' runs the staged loop")
    LAST_SS_PATH = path
    dev = omega.device

    # The fused loop's omega at the bf16 modes (ss_pallas.py:409-413): one
    # bf16 stream, from which u0 is formed too; no float32 copy of it.
    om16 = None
    if path == fused and precision in ("default", "sr"):
        om16 = omega_bf16_stream(omega)
        u = kappa - om16[:, :N] * psi
    else:
        u = kappa - omega * psi
    w = w_full.clone()
    hyp = hyp._replace(mu=hyp.mu.contiguous(), Lam=hyp.Lam.contiguous(),
                       logit_rho=hyp.logit_rho.contiguous())
    A = torch.empty((N_pre, N), dtype=torch.float32, device=dev)
    if path == staged:
        sum_om = _staged_loop(generator, Xt, omega, u, w, hyp, A, G, B,
                              noise, precision, Jg, shard)
    else:
        sum_om = _fused_loop(generator, host_generator, Xt, omega, om16, u,
                             w, hyp, A, G, B, noise, precision, shard)

    # Bias column (always active): X_bias = ones.
    u_sum = u.sum(0)
    if shard is not None:               # one all-reduce of both sums
        sums = _time_sum(torch.cat([sum_om, u_sum]), mesh)
        sum_om, u_sum = sums[:N], sums[N:]
    b_old = w[P - 1].clone()
    m_b = u_sum + sum_om * b_old + hyp.lam_b * hyp.mu_b
    lam_p = hyp.lam_b + sum_om
    z_b = (torch.randn((N if shard is None else shard.n_lanes,),
                       generator=generator, device=dev)
           if noise is None else noise.bias)
    if shard is not None:
        z_b = z_b[shard.lanes]
    b_new = m_b / lam_p + z_b / torch.sqrt(lam_p)
    u -= omega * (b_new - b_old)[None, :]
    w[P - 1] = b_new
    return A, w, u, sum_om

