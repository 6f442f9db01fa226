"""Kernels K2 (``csrc/ss_group_pass.cu``) and K3 (``csrc/ss_edge_scan.cu``)
of the grouped spike-and-slab update, each with its plain PyTorch version.

The TPU runs the whole update as one Pallas kernel whose grid walks
(group, time chunk) in order and runs the edge scan in-kernel at each group
boundary (``pyglm_tpu/ops/ss_pallas.py::resample_spike_slab_fused``). Hopper
blocks run in no order, so the group loop lives on the host
(models/weights.py) as Ng x (K2 + K3) launches plus K2's epilogue.

Layouts (postsyn lanes n last, float32, contiguous):
  xp, xg   (GB, T)   design rows of groups g-1 and g (rows of Xt)
  omega, u (T, N)
  dw, m0, w (GB, N)
  jgg      (GB(GB+1)/2, N)  packed upper triangle of X_g diag(omega_n) X_g^T,
                            row-major over p <= q (``torch.triu_indices``)
  mu (G, N, B), lam (G, N, B, B), lrho (G, N), u_a (G, N), eps (G, N, B)

K2's Gram runs in the mode of the caller's precision, as the TPU kernel's
`gram` (``ss_pallas.py:343-349``): "high" 3xTF32 (``csrc/gram_tc.cuh``),
"default" one bf16 pass (Z and omega rounded to nearest even), "sr" one
bf16 pass on a stochastically rounded Z, both on wgmma
(``csrc/gram_wgmma.cuh``) over a bf16 omega stream (:func:`omega_bf16_stream`,
made once per update by the fused loop) with T split as
:func:`gram_split_plan` says. The words of "sr"'s rounding come from a
Philox stream selected by a (seed, offset) pair per call, on the card in the
kernel and on the CPU from :func:`sr_words`, which repeats the kernel's
draw, so both devices round Z alike for one pair.

Dispatch: :func:`ss_group_pass` and :func:`ss_edge_scan` launch the kernel
for CUDA tensors and take the plain version for CPU tensors only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from pyglm_tpu_torch.ops import _build

_MAX_GB = 64           # K2 keeps a group's design rows in shared memory
_MAX_B = 8             # K3 is instantiated for B = 1 .. 8
_K3_SMEM = 232448      # K3: the shared memory a block may take (227 KB)
_K3_TILES = (32, 16, 8)   # K3's lane tiles, widest first


def pair_index(GB: int, device=None):
    """(p, q) row indices of the packed upper triangle, p <= q."""
    iu = torch.triu_indices(GB, GB, device=device)
    return iu[0], iu[1]


def unpack_gram(jgg: torch.Tensor, GB: int) -> torch.Tensor:
    """Packed (GB(GB+1)/2, N) -> full symmetric (N, GB, GB)."""
    p, q = pair_index(GB, jgg.device)
    full = jgg.new_zeros((GB, GB, jgg.shape[1]))
    full[p, q] = jgg
    full[q, p] = jgg
    return full.permute(2, 0, 1)


# ---------------------------------------------------------------------------
# The bf16 rounding of the Gram modes "default" and "sr"
# ---------------------------------------------------------------------------

# K2's Gram modes (the `gram` argument of ss_group_pass_launch) and their
# launch counters.
_GRAM_MODES = {"high": 0, "default": 1, "sr": 2}
_K2_KEYS = {"high": "ss_group_pass", "default": "ss_group_pass_bf16",
            "sr": "ss_group_pass_sr"}

_M32 = np.uint64(0xFFFFFFFF)


def philox4x32(c, k):
    """Philox4x32-10 over numpy arrays: c a 4-tuple of counter words, k a
    2-tuple of key words (each an array of 32-bit values, broadcast
    together); returns the 4 output words as uint64 arrays (the generator
    of csrc/gram_wgmma.cuh::philox)."""
    c = [np.asarray(x, np.uint64) for x in np.broadcast_arrays(*c)]
    k0, k1 = (np.asarray(x, np.uint64) for x in k)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _M32]
        k0 = (k0 + np.uint64(0x9E3779B9)) & _M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & _M32
    return c


def sr_words(seed: int, offset: int, rows: int, T: int) -> torch.Tensor:
    """The (rows, T) int32 words in [0, 2^16) with which K2 rounds
    Z[pr, t] at "sr" for this (seed, offset): word t % 8 of the Philox draw
    with counter (t // 8, pr, offset) and key seed (the low 16 bits of each
    output word first)."""
    t8 = np.arange(-(-T // 8), dtype=np.uint64)[None, :]
    pr = np.arange(rows, dtype=np.uint64)[:, None]
    off, sd = np.uint64(offset), np.uint64(seed)
    out = philox4x32((t8, pr, off & _M32, off >> np.uint64(32)),
                     (sd & _M32, sd >> np.uint64(32)))
    words = np.stack([w for x in out for w in (x & np.uint64(0xFFFF),
                                               x >> np.uint64(16))], axis=-1)
    return torch.from_numpy(
        words.reshape(rows, -1)[:, :T].astype(np.int32))


def sr_round(x: torch.Tensor, r16: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of float32 x to bf16 by the words r16 in
    [0, 2^16) (``ss_pallas.py::_sr16``): (bits(x) + r16) & 0xFFFF0000, so
    each value lands on one of its two bf16 neighbours, E[sr(x)] = x over
    uniform words, and bf16 values pass through. Returns float32."""
    return ((x.view(torch.int32) + r16) & -65536).view(torch.float32)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def omega_bf16_stream(omega: torch.Tensor) -> torch.Tensor:
    """omega rounded once to bf16 (to nearest even, the values of
    ``to_bf16``), as the (T, N8) torch.bfloat16 operand of the wgmma Gram
    bodies (K2's "default" and "sr", K6's "default"): N8 = N rounded up to a
    multiple of 8, the pad lanes zero, so that every row starts on a 16-byte
    boundary."""
    T, N = omega.shape
    N8 = -(-N // 8) * 8
    if N8 == N:
        return omega.to(torch.bfloat16).contiguous()
    out = omega.new_zeros((T, N8), dtype=torch.bfloat16)
    out[:, :N] = omega
    return out


# ---------------------------------------------------------------------------
# The tiles of the wgmma Gram body (csrc/gram_wgmma.cuh)
# ---------------------------------------------------------------------------

PAIR_TILE = 168        # pair rows per tile of K6 (gram_wgmma.cuh kNP)
K2_PAIR_TILE = 176     # ... of K2 (ss_group_pass.cu kK2NP)
LANE_TILE = 128        # postsyn lanes per tile (kLT)
STAGE_STEPS = 64       # time steps per stage (kKS)
_NO_PAIR = -1          # 0xFFFF as int16: a row past the last pair
_H100_SMS = 132


def pair_tile_plan(GB: int, device=None, tile: int = PAIR_TILE
                   ) -> torch.Tensor:
    """The pair table of the wgmma body: the packed pair rows of a group of
    GB design rows (``pair_index``, row-major over p <= q) in tiles of
    `tile` rows (PAIR_TILE for K6, K2_PAIR_TILE for K2), as int16 entries
    p | q << 8, the last tile padded with -1 (no pair). Shape (n_tiles *
    tile,); a block of pair tile x takes entries [x tile, (x + 1) tile)."""
    p, q = pair_index(GB, device)
    n_tiles = -(-p.numel() // tile)
    table = torch.full((n_tiles * tile,), _NO_PAIR, dtype=torch.int16,
                       device=device)
    table[:p.numel()] = (p | (q << 8)).to(torch.int16)
    return table


@functools.lru_cache(maxsize=None)
def _pair_table(GB: int, device: torch.device,
                tile: int = PAIR_TILE) -> torch.Tensor:
    return pair_tile_plan(GB, device, tile)


def gram_split_plan(T: int, N: int, GB: int,
                    n_sm: int = _H100_SMS) -> tuple[int, int]:
    """(n_split, steps per split) of K2's wgmma Gram: split s takes the
    steps [s steps, min(T, (s + 1) steps)), steps a multiple of the
    64-step stage, so that every split starts on a stage and on an 8-step
    Philox chunk, and no split is empty. The grid is n_split x (pair tiles
    x lane tiles) blocks at one block per SM: as many splits as fill one
    wave of `n_sm` SMs with whole splits, but at least 8 stages per split
    and partials (n_split x npair x N float32) at most a quarter of the
    bf16 omega stream's bytes. At the flagship group (GB = 32, N = 200,
    T = 1e5: 3 x 2 tiles) 22 splits of 4608 steps, 132 blocks."""
    npair = GB * (GB + 1) // 2
    tiles = -(-npair // K2_PAIR_TILE) * -(-N // LANE_TILE)
    stages = -(-T // STAGE_STEPS)
    n_split = max(1, min(n_sm // tiles, stages // 8, T // (8 * npair)))
    steps = -(-stages // n_split) * STAGE_STEPS
    return -(-T // steps), steps


# ---------------------------------------------------------------------------
# K2: scatter + gather + within-group Gram
# ---------------------------------------------------------------------------

def ss_group_pass_plain(xp, xg, omega, u, dw, want_sum_omega=False,
                        precision="high", r16=None):
    """Plain version of K2. Updates u in place,
    u -= omega * (xp^T dw) when xp is given, and returns
    (M0 = xg u, packed Jgg, sum_t omega or None); (None, None, None) when
    xg is None (the epilogue). The Gram at `precision`: "high" fp32,
    "default" bf16(Z) bf16(omega), "sr" sr_round(Z, r16) bf16(omega) with
    r16 the (GB(GB+1)/2, T) words of the rounding; products of bf16 values
    are exact in fp32, so only the order of the sums differs from K2."""
    if xp is not None:
        u -= omega * (xp.T @ dw)
    if xg is None:
        return None, None, None
    m0 = xg @ u
    p, q = pair_index(xg.shape[0], xg.device)
    Z = xg[p] * xg[q]
    if precision == "high":
        jgg = Z @ omega
    elif precision == "default":
        jgg = to_bf16(Z) @ to_bf16(omega)
    elif precision == "sr":
        jgg = sr_round(Z, r16) @ to_bf16(omega)
    else:
        raise ValueError(f"ss_group_pass: precision={precision!r}, one of "
                         f"{tuple(_GRAM_MODES)}")
    return m0, jgg, (omega.sum(0) if want_sum_omega else None)


def _check_cuda_f32(name, t, shape):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


# K2's tensor-core Gram tile (csrc/gram_tc.cuh) and its grid target.
_TC_ROWS, _TC_LANES = 64, 128
_K2_BLOCKS = 1152


def _n_split(T: int, N: int, GB: int) -> int:
    """Time splits of K2's 3xTF32 Gram: about _K2_BLOCKS blocks in all
    (~4.4 waves of 2 blocks on each of the H100's 132 SMs; 58 and 114 splits
    measured slower at the flagship), at least 256 time steps per split and
    at most 128 splits. At the flagship (T = 1e5, N = 200, GB = 32: 2 lane
    x 9 row tiles) that is 64 splits; at 4000 lanes and GB = 40 (32 x 13
    tiles) 3, so the partials stay small."""
    tiles = (-(-N // _TC_LANES)) * (-(-(GB * (GB + 1) // 2) // _TC_ROWS))
    return max(1, min(128, -(-T // 256), -(-_K2_BLOCKS // tiles)))


def _n_split_m0(T: int, N: int, GB: int) -> int:
    """Time splits of K2's M0 = X_g u on the tensor cores: about 528
    blocks (2 waves), at least 256 steps each (128 splits at the
    flagship)."""
    tiles = (-(-N // _TC_LANES)) * (-(-GB // _TC_ROWS))
    return max(1, min(128, -(-T // 256), -(-528 // tiles)))


def _n_split_scatter(T: int) -> int:
    """Time splits of K2's scatter: ~256 steps each (391 at T = 1e5), so
    enough lanes x splits stream u and omega at once."""
    return max(1, min(1024, -(-T // 256)))


def _check_om16(om16, omega):
    """The bf16 omega operand must be ``omega_bf16_stream(omega)``'s
    layout: contiguous (T, N8) torch.bfloat16 on omega's device."""
    T, N = omega.shape
    N8 = -(-N // 8) * 8
    if (om16.dtype != torch.bfloat16 or tuple(om16.shape) != (T, N8)
            or not om16.is_contiguous() or om16.device != omega.device):
        raise ValueError(f"om16: need a contiguous ({T}, {N8}) bfloat16 "
                         f"tensor on {omega.device} (omega_bf16_stream), got "
                         f"{om16.dtype} {tuple(om16.shape)} on {om16.device}")


def ss_group_pass_cuda(xp, xg, omega, u, dw, want_sum_omega=False,
                       precision="high", sr_seed=(0, 0), om16=None):
    """K2 on the card; same contract as :func:`ss_group_pass_plain`. The
    Gram runs in `precision`'s mode: "high" 3xTF32 on the mma.sync tile
    loop; "default" and "sr" one bf16 pass on wgmma over `om16`, omega's
    bf16 stream (:func:`omega_bf16_stream`; made here when not given), "sr"
    rounding Z by the Philox words of ``sr_seed`` = (seed, offset), those of
    :func:`sr_words`. M0 runs 3xTF32 and the scatter and sum_t omega fp32
    (on the float32 omega) in every mode."""
    if precision not in _GRAM_MODES:
        raise ValueError(f"ss_group_pass: precision={precision!r}, one of "
                         f"{tuple(_GRAM_MODES)}")
    seed, offset = sr_seed
    if not (0 <= seed < 2 ** 64 and 0 <= offset < 2 ** 64):
        raise ValueError("sr_seed: seed and offset must fit in 64 unsigned "
                         "bits")
    T, N = omega.shape
    ref = xg if xg is not None else xp
    if ref is None:
        raise ValueError("ss_group_pass: need xg, xp or both")
    GB = ref.shape[0]
    if not 1 <= GB <= _MAX_GB:
        raise ValueError(f"ss_group_pass: GB={GB} outside 1..{_MAX_GB}")
    _check_cuda_f32("omega", omega, (T, N))
    _check_cuda_f32("u", u, (T, N))
    if xg is not None:
        _check_cuda_f32("xg", xg, (GB, T))
    if xp is not None:
        _check_cuda_f32("xp", xp, (GB, T))
        _check_cuda_f32("dw", dw, (GB, N))
    npair = GB * (GB + 1) // 2
    dev = omega.device
    # The wgmma body's operands: omega's bf16 stream and the pair table.
    om16_p = pq_p = None
    N8, ntile = N, 0
    if precision != "high" and xg is not None:
        if om16 is None:
            om16 = omega_bf16_stream(omega)
        _check_om16(om16, omega)
        pq = _pair_table(GB, dev, K2_PAIR_TILE)
        om16_p, pq_p = om16.data_ptr(), pq.data_ptr()
        N8, ntile = om16.shape[1], pq.numel() // K2_PAIR_TILE
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = gram_split_plan(T, N, GB, n_sm)[0]
    else:
        n_split = _n_split(T, N, GB)
    n_split_m, n_split_s = _n_split_m0(T, N, GB), _n_split_scatter(T)
    part_g = part_m = part_s = out = None
    if xg is not None:
        f32 = dict(dtype=torch.float32, device=dev)
        part_g = torch.empty((n_split, npair, N), **f32)
        part_m = torch.empty((n_split_m, GB, N), **f32)
        part_s = torch.empty((n_split_s, N), **f32)
        out = torch.empty((GB + npair + 1, N), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_group_pass_launch(
            ptr(xg), ptr(xp), omega.data_ptr(), om16_p, pq_p, u.data_ptr(),
            ptr(dw) if xp is not None else None, ptr(part_g), ptr(part_m),
            ptr(part_s), ptr(out), T, N, N8, GB, n_split, n_split_m,
            n_split_s, ntile, int(want_sum_omega), _GRAM_MODES[precision],
            seed, offset,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ss_group_pass")
    _build.LAUNCHES[_K2_KEYS[precision]] += 1
    if xg is None:
        return None, None, None
    return (out[:GB], out[GB:GB + npair],
            out[GB + npair] if want_sum_omega else None)


def ss_group_pass(xp, xg, omega, u, dw, want_sum_omega=False,
                  precision="high", sr_seed=(0, 0), om16=None):
    """K2 for CUDA tensors, its plain version for CPU tensors; at "sr" both
    round Z by the words of ``sr_seed`` = (seed, offset). `om16`, omega's
    bf16 stream (:func:`omega_bf16_stream`), is checked on either device
    when given and read only by the card's bf16 and SR Gram bodies; the
    plain version rounds omega itself."""
    if om16 is not None:
        _check_om16(om16, omega)
    if omega.is_cuda:
        return ss_group_pass_cuda(xp, xg, omega, u, dw, want_sum_omega,
                                  precision, sr_seed, om16)
    if omega.device.type != "cpu":
        raise ValueError(f"ss_group_pass: unsupported device {omega.device}")
    r16 = None
    if precision == "sr" and xg is not None:
        GB = xg.shape[0]
        r16 = sr_words(*sr_seed, GB * (GB + 1) // 2, omega.shape[0])
    return ss_group_pass_plain(xp, xg, omega, u, dw, want_sum_omega,
                               precision, r16)


# ---------------------------------------------------------------------------
# K3: the edge scan of one group
# ---------------------------------------------------------------------------

def ss_edge_scan_plain(jgg, m0, w, mu, lam, lrho, u_a, eps):
    """Plain version of K3: the collapsed Gibbs over one group's G edges
    (models/weights.py::_group_edge_scan on the unpacked Gram). Updates w
    in place and returns (dW (GB, N), a (G, N))."""
    from pyglm_tpu_torch.models.weights import _group_edge_scan
    from pyglm_tpu_torch.ops.linalg import chol_small
    GB = m0.shape[0]
    ld0 = torch.log(torch.diagonal(chol_small(lam), dim1=-2,
                                   dim2=-1)).sum(-1)
    dW, w_new, a = _group_edge_scan(unpack_gram(jgg, GB), m0, w, mu, lam,
                                    ld0, lrho, u_a, eps)
    w.copy_(w_new)
    return dW, a


def edge_scan_smem_bytes(G: int, B: int, tile: int) -> int:
    """Shared memory of one K3 block of `tile` lanes: the packed Gram slice,
    the residual and the old weights, the current edge's dW, and per edge
    the packed chol(Lam0 + J_ii), Lp^{-T} eps, the log-odds' constant part
    and u_a, each a row of `tile` floats (the layout of
    csrc/ss_edge_scan.cu, whose launcher refuses a block past 227 KB)."""
    GB = G * B
    rows = (GB * (GB + 1) // 2 + 2 * GB + B
            + G * (B * (B + 1) // 2 + B + 2))
    return 4 * tile * rows


def edge_scan_plan(G: int, B: int, N: int) -> int:
    """K3's lane tile for a group of G edges of B basis weights at N lanes:
    the widest of ``_K3_TILES`` whose block fits 227 KB of shared memory
    and whose grid still puts a block on every SM, else 8 lanes (a row of a
    tile is then one 32-byte sector). At the flagship's group (200 lanes)
    that is 8 lanes, 25 blocks; at config 5's (4000 lanes) 16, 250 blocks:
    the fastest tiles measured there (PERF.md). Raises for GB > 64, as K2
    and K6 do; every GB up to 64 fits at 16 lanes (165 KB at most)."""
    if not 1 <= G * B <= _MAX_GB:
        raise ValueError(f"ss_edge_scan: GB={G * B} outside 1..{_MAX_GB}")
    for tile in _K3_TILES:
        if (edge_scan_smem_bytes(G, B, tile) <= _K3_SMEM
                and -(-N // tile) >= _H100_SMS):
            return tile
    return 8


def ss_edge_scan_cuda(jgg, m0, w, mu, lam, lrho, u_a, eps):
    """K3 on the card; same contract as :func:`ss_edge_scan_plain`. A
    block serves the lane tile of :func:`edge_scan_plan`."""
    G, N, B = mu.shape
    GB = G * B
    if not 1 <= B <= _MAX_B:
        raise ValueError(f"ss_edge_scan: B={B} outside 1..{_MAX_B}")
    tile = edge_scan_plan(G, B, N)
    for name, t, shape in (
            ("jgg", jgg, (GB * (GB + 1) // 2, N)), ("m0", m0, (GB, N)),
            ("w", w, (GB, N)), ("mu", mu, (G, N, B)),
            ("lam", lam, (G, N, B, B)), ("lrho", lrho, (G, N)),
            ("u_a", u_a, (G, N)), ("eps", eps, (G, N, B))):
        _check_cuda_f32(name, t, shape)
    dev = m0.device
    dW = torch.empty((GB, N), dtype=torch.float32, device=dev)
    a = torch.empty((G, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_edge_scan_launch(
            jgg.data_ptr(), m0.data_ptr(), w.data_ptr(), dW.data_ptr(),
            a.data_ptr(), mu.data_ptr(), lam.data_ptr(), lrho.data_ptr(),
            u_a.data_ptr(), eps.data_ptr(), G, B, N, tile.bit_length() - 1,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ss_edge_scan")
    _build.LAUNCHES["ss_edge_scan"] += 1
    return dW, a


def ss_edge_scan(jgg, m0, w, mu, lam, lrho, u_a, eps):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    if m0.is_cuda:
        return ss_edge_scan_cuda(jgg, m0, w, mu, lam, lrho, u_a, eps)
    if m0.device.type != "cpu":
        raise ValueError(f"ss_edge_scan: unsupported device {m0.device}")
    return ss_edge_scan_plain(jgg, m0, w, mu, lam, lrho, u_a, eps)
