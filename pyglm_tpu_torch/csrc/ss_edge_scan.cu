// K3: the collapsed spike-and-slab Gibbs scan over one group's G presyn
// edges for every postsyn lane n, edges in order. A block serves a tile of
// TL lanes (ops/ss_cuda.py::edge_scan_plan picks TL per call).
//
// Replaces pyglm_tpu/ops/ss_pallas.py::_edge_scan, the in-kernel edge scan
// that the fused TPU kernel runs at each group boundary; its math is that of
// pyglm_tpu/models/weights.py::_group_edge_scan + _batched_evidence. Per
// edge i of the group, lane n:
//   m      = M0_i - sum_{q < iB} J[iB+b, q] dW_q + J_ii w_i
//   Lp     = Lam0 + J_ii,  bpost = m + Lam0 mu0,  z = Lp^{-1} bpost (chol)
//   log_ev = |z|^2/2 - mu0' Lam0 mu0 / 2 + log|L0| - log|Lp|   (chol diags)
//   a      = u_a < logistic(logit rho + log_ev)
//   w      = a * (Lp^{-T} z + Lp^{-T} eps),   dW_i = w - w_old
// with B x B Choleskys unrolled at compile time (B is a template parameter,
// instantiated for B = 1 .. 8).
//
// The noise is an input: u_a (G, N) and eps (G, N, B) are drawn by torch
// from the model's generator, G N (1 + B) values per group. The kernel and
// its plain version then agree to f32 rounding given the same noise.
//
// Bound on the H100: latency, not bytes or arithmetic. A call moves the
// packed Gram slice (GB(GB+1)/2 rows of N lanes: 0.4 MB at the flagship,
// 13 MB at config 5) and a few times GB N priors and outputs, a few us at
// 3.35 TB/s, and does a few hundred flops per edge and lane. What takes
// the time is the chain of dependent steps: the edges are visited in order
// and edge i's linear term m needs the dW of every earlier edge. One thread
// per lane that walks its Gram column from device memory pays a load
// latency per product, B^2 G (G - 1) / 2 of them (448 at the flagship, 720
// at config 5), with one warp or less per SM to hide them. So the design:
//   1. Staging: the block copies its lanes' Gram rows, M0 and w into shared
//      memory ([row][lane], threads along the lanes) with every copy in
//      flight at once (cp.async, 16 bytes where the rows are aligned), and
//      waits once.
//   2. A parallel prologue over the G x TL (edge, lane) pairs computes all
//      that does not depend on the scan: chol(Lam0), log|L0|, Lam0 mu0 and
//      mu0' Lam0 mu0, chol(Lam0 + J_ii) and log|Lp|, Lp^{-T} eps, and the
//      residual r_i = M0_i + J_ii w_i + Lam0 mu0 (bpost before the earlier
//      edges' updates), all into shared memory.
//   3. The serial scan keeps only what must be serial. For edge i one
//      thread per lane solves z = Lp^{-1} r_i, decides a, draws w and
//      writes dW_i; after a barrier the whole block applies the rank-B
//      update r_q -= J[q, iB:iB+B] dW_i to the rows of the later edges.
// Every operand of the scan is then in shared memory, so a step costs a
// few dependent shared loads and flops instead of device-memory latencies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "copy_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;       // 227 KB a block (H100)

template <int B>
__device__ void chol(const float (&A)[B][B], float (&L)[B][B]) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float d = sqrtf(s);
    L[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < B; ++i) {
      float s2 = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= L[i][k] * L[j][k];
      L[i][j] = s2 * inv_d;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) L[i][j] = 0.0f;
  }
}

// Solves L^T x = b in place.
template <int B>
__device__ void solve_lower_t(const float (&L)[B][B], float (&x)[B]) {
#pragma unroll
  for (int i = B - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int k = i + 1; k < B; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// Row of (p, q), p <= q, in the packed upper triangle of a GB x GB matrix.
__device__ __forceinline__ int prow(int p, int q, int GB) {
  return p * GB - p * (p - 1) / 2 + (q - p);
}

// Shared memory, in rows of TL floats: the Gram slice (npair rows), the
// residual r and the old weights (GB rows each), the current edge's dW (B),
// then per edge the packed chol(Lam0 + J_ii) (B(B+1)/2), Lp^{-T} eps (B),
// the log-odds less |z|^2/2 and u_a (1 each). ops/ss_cuda.py repeats this
// count in edge_scan_smem_bytes.
template <int B>
__global__ void __launch_bounds__(kThreads)
edge_scan_kernel(const float* __restrict__ jgg, const float* __restrict__ m0,
                 float* __restrict__ w, float* __restrict__ dw,
                 float* __restrict__ a_out, const float* __restrict__ mu,
                 const float* __restrict__ lam,
                 const float* __restrict__ lrho,
                 const float* __restrict__ ua, const float* __restrict__ eps,
                 int G, int N, int lt, bool vec) {
  constexpr int kTri = B * (B + 1) / 2;
  extern __shared__ float sm[];
  const int TL = 1 << lt;
  const int GB = G * B, npair = GB * (GB + 1) / 2;
  float* sJ = sm;                          // [npair][TL]
  float* sR = sJ + (npair << lt);          // [GB][TL]
  float* sW = sR + (GB << lt);             // [GB][TL]
  float* sD = sW + (GB << lt);             // [B][TL]
  float* sL = sD + (B << lt);              // [G][kTri][TL]
  float* sE = sL + ((G * kTri) << lt);     // [G][B][TL]
  float* sC = sE + ((G * B) << lt);        // [G][TL]
  float* sU = sC + (G << lt);              // [G][TL]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x << lt;

  // 1. Staging: Gram rows, then M0 into r, then w, as one run of rows.
  const int rows = npair + 2 * GB;
  auto src_row = [&](int row) -> const float* {
    return row < npair ? jgg + (size_t)row * N
           : row < npair + GB ? m0 + (size_t)(row - npair) * N
                              : w + (size_t)(row - npair - GB) * N;
  };
  if (vec) {                               // rows 16-byte aligned
    const int cl = lt - 2;
    for (int k = tid; k < (rows << cl); k += kThreads) {
      const int row = k >> cl, c = (k & ((1 << cl) - 1)) << 2;
      const bool ok = n0 + c < N;
      copy_reduce::cp_async16(sm + (row << lt) + c,
                              ok ? src_row(row) + n0 + c : jgg, ok);
    }
  } else {
    for (int k = tid; k < (rows << lt); k += kThreads) {
      const int row = k >> lt, c = k & (TL - 1);
      const bool ok = n0 + c < N;
      copy_reduce::cp_async4(sm + (row << lt) + c,
                             ok ? src_row(row) + n0 + c : jgg, ok);
    }
  }
  copy_reduce::cp_async_commit();
  copy_reduce::cp_async_wait<0>();
  __syncthreads();

  // 2. Prologue over (edge, lane). Lanes past N take Lam0 = I and zeros.
  for (int k = tid; k < (G << lt); k += kThreads) {
    const int i = k >> lt, l = k & (TL - 1), n = n0 + l, iB = i * B;
    const bool ok = n < N;
    const size_t hn = (size_t)i * N + n;
    float lam0[B][B], mu0[B], e[B], lp[B][B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      mu0[b] = ok ? mu[hn * B + b] : 0.0f;
      e[b] = ok ? eps[hn * B + b] : 0.0f;
#pragma unroll
      for (int c = 0; c < B; ++c)
        lam0[b][c] = ok ? lam[(hn * B + b) * B + c] : (b == c ? 1.0f : 0.0f);
    }
    float r[B], quad0 = 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float s = sR[((iB + b) << lt) + l], t = 0.0f;
#pragma unroll
      for (int c = 0; c < B; ++c) {
        const int p = min(b, c) + iB, q = max(b, c) + iB;
        const float jbc = sJ[(prow(p, q, GB) << lt) + l];
        s += jbc * sW[((iB + c) << lt) + l];
        t += lam0[b][c] * mu0[c];
        lp[b][c] = lam0[b][c] + jbc;
      }
      r[b] = s + t;
      quad0 += mu0[b] * t;
    }
    float L0[B][B], Lp[B][B];
    chol<B>(lam0, L0);
    chol<B>(lp, Lp);
    float ld0 = 0.0f, ldp = 0.0f;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      ld0 += logf(L0[b][b]);
      ldp += logf(Lp[b][b]);
    }
    solve_lower_t<B>(Lp, e);               // Lp^{-T} eps
#pragma unroll
    for (int b = 0; b < B; ++b) {
      sR[((iB + b) << lt) + l] = r[b];
      sE[((i * B + b) << lt) + l] = e[b];
#pragma unroll
      for (int c = 0; c <= b; ++c)
        sL[((i * kTri + b * (b + 1) / 2 + c) << lt) + l] = Lp[b][c];
    }
    sC[(i << lt) + l] = (ok ? lrho[hn] : 0.0f) - 0.5f * quad0 + ld0 - ldp;
    sU[(i << lt) + l] = ok ? ua[hn] : 1.0f;
  }
  __syncthreads();

  // 3. The scan.
  for (int i = 0; i < G; ++i) {
    const int iB = i * B;
    if (tid < TL) {
      const int l = tid, n = n0 + l;
      float Lp[B][B], z[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int c = 0; c < B; ++c)
          Lp[b][c] = c <= b ? sL[((i * kTri + b * (b + 1) / 2 + c) << lt) + l]
                            : 0.0f;
      }
      float quadp = 0.0f;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        float s = sR[((iB + b) << lt) + l];
#pragma unroll
        for (int k = 0; k < b; ++k) s -= Lp[b][k] * z[k];
        z[b] = s / Lp[b][b];
        quadp += z[b] * z[b];
      }
      const float log_odds = sC[(i << lt) + l] + 0.5f * quadp;
      const bool active =
          sU[(i << lt) + l] < 1.0f / (1.0f + expf(-log_odds));
      solve_lower_t<B>(Lp, z);            // posterior mean
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float wn = active ? z[b] + sE[((i * B + b) << lt) + l] : 0.0f;
        const float d = wn - sW[((iB + b) << lt) + l];
        sD[(b << lt) + l] = d;
        if (n < N) {
          dw[(size_t)(iB + b) * N + n] = d;
          w[(size_t)(iB + b) * N + n] = wn;
        }
      }
      if (n < N) a_out[(size_t)i * N + n] = active ? 1.0f : 0.0f;
    }
    if (i == G - 1) break;
    __syncthreads();
    // Rank-B update of the later edges' rows: r_q -= J[q, iB:iB+B] dW_i.
    const int q0 = iB + B;
    for (int k = tid; k < ((GB - q0) << lt); k += kThreads) {
      const int q = q0 + (k >> lt), l = k & (TL - 1);
      float s = sR[(q << lt) + l];
#pragma unroll
      for (int c = 0; c < B; ++c)
        s -= sJ[(prow(iB + c, q, GB) << lt) + l] * sD[(c << lt) + l];
      sR[(q << lt) + l] = s;
    }
    __syncthreads();
  }
}

// Rows of TL floats of shared memory a block takes (see the kernel).
int smem_rows(int G, int B) {
  const int GB = G * B;
  return GB * (GB + 1) / 2 + 2 * GB + B + G * (B * (B + 1) / 2 + B + 2);
}

template <int B>
cudaError_t launch(const float* jgg, const float* m0, float* w, float* dw,
                   float* a, const float* mu, const float* lam,
                   const float* lrho, const float* ua, const float* eps,
                   int G, int N, int lt, cudaStream_t s) {
  const long long bytes = 4LL * smem_rows(G, B) << lt;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      edge_scan_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const auto al16 = [](const void* p) {
    return ((uintptr_t)p & 15) == 0;
  };
  const bool vec = N % 4 == 0 && al16(jgg) && al16(m0) && al16(w);
  const int blocks = (N + (1 << lt) - 1) >> lt;
  edge_scan_kernel<B><<<blocks, kThreads, (size_t)bytes, s>>>(
      jgg, m0, w, dw, a, mu, lam, lrho, ua, eps, G, N, lt, vec);
  return cudaGetLastError();
}

}  // namespace

// jgg: (GB(GB+1)/2, N) packed within-group Gram; m0, w: (GB, N), w updated
// in place; dw: (GB, N) out; a: (G, N) out; mu: (G, N, B); lam: (G, N, B, B);
// lrho, ua: (G, N); eps: (G, N, B). All float32, contiguous. A block serves
// 2^lane_shift lanes (3..5).
extern "C" int ss_edge_scan_launch(const float* jgg, const float* m0,
                                   float* w, float* dw, float* a,
                                   const float* mu, const float* lam,
                                   const float* lrho, const float* ua,
                                   const float* eps, int G, int B, int N,
                                   int lane_shift, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (G < 1 || N < 1 || lane_shift < 3 || lane_shift > 5)
    return (int)cudaErrorInvalidValue;
  switch (B) {
#define PGT_CASE(b)                                                        \
  case b:                                                                  \
    return (int)launch<b>(jgg, m0, w, dw, a, mu, lam, lrho, ua, eps, G, N, \
                          lane_shift, s);
    PGT_CASE(1) PGT_CASE(2) PGT_CASE(3) PGT_CASE(4)
    PGT_CASE(5) PGT_CASE(6) PGT_CASE(7) PGT_CASE(8)
#undef PGT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
