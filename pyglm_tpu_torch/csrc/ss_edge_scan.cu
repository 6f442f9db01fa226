// K3: the collapsed spike-and-slab Gibbs scan over one group's G presyn
// edges, one thread per postsyn lane n, edges in order.
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
// Bound on the H100: latency. At N = 200 the launch has 200 threads on two
// SMs, and each thread runs G sequential edge steps of a few hundred flops.
// The packed Gram (GB(GB+1)/2 rows) and the dW rows are read lane-major, so
// every load is coalesced across the warp. Acceptable for this slice; the
// sweep issues it once per group.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

template <int B>
__global__ void edge_scan_kernel(const float* __restrict__ jgg,
                                 const float* __restrict__ m0,
                                 float* __restrict__ w,
                                 float* __restrict__ dw,
                                 float* __restrict__ a_out,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ lam,
                                 const float* __restrict__ lrho,
                                 const float* __restrict__ ua,
                                 const float* __restrict__ eps, int G,
                                 int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int GB = G * B;
  // Packed upper triangle, row-major over p <= q.
  auto J = [&](int p, int q) -> float {
    if (p > q) {
      const int t = p;
      p = q;
      q = t;
    }
    const int row = p * GB - p * (p - 1) / 2 + (q - p);
    return jgg[(size_t)row * N + n];
  };

  for (int i = 0; i < G; ++i) {
    const int iB = i * B;
    const size_t hn = (size_t)i * N + n;
    float wold[B], mu0[B], lam0[B][B], lp[B][B], m[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      wold[b] = w[(size_t)(iB + b) * N + n];
      mu0[b] = mu[hn * B + b];
#pragma unroll
      for (int c = 0; c < B; ++c) lam0[b][c] = lam[(hn * B + b) * B + c];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float s = m0[(size_t)(iB + b) * N + n];
      for (int q = 0; q < iB; ++q) s -= J(iB + b, q) * dw[(size_t)q * N + n];
#pragma unroll
      for (int c = 0; c < B; ++c) {
        const float jbc = J(iB + b, iB + c);
        s += jbc * wold[c];
        lp[b][c] = lam0[b][c] + jbc;
      }
      m[b] = s;
    }
    float L0[B][B], Lp[B][B];
    chol<B>(lam0, L0);
    chol<B>(lp, Lp);

    float ld0 = 0.0f, ldp = 0.0f, quad0 = 0.0f, quadp = 0.0f;
    float z[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      ld0 += logf(L0[b][b]);
      ldp += logf(Lp[b][b]);
      float s = m[b], t = 0.0f;
#pragma unroll
      for (int c = 0; c < B; ++c) {
        s += lam0[b][c] * mu0[c];
        t += lam0[b][c] * mu0[c];
      }
      quad0 += mu0[b] * t;
#pragma unroll
      for (int k = 0; k < b; ++k) s -= Lp[b][k] * z[k];
      z[b] = s / Lp[b][b];
      quadp += z[b] * z[b];
    }
    const float log_odds =
        lrho[hn] + 0.5f * quadp - 0.5f * quad0 + ld0 - ldp;
    const bool active = ua[hn] < 1.0f / (1.0f + expf(-log_odds));

    float e[B];
#pragma unroll
    for (int b = 0; b < B; ++b) e[b] = eps[hn * B + b];
    solve_lower_t<B>(Lp, z);          // posterior mean
    solve_lower_t<B>(Lp, e);          // Lp^{-T} eps
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const float wn = active ? z[b] + e[b] : 0.0f;
      dw[(size_t)(iB + b) * N + n] = wn - wold[b];
      w[(size_t)(iB + b) * N + n] = wn;
    }
    a_out[hn] = active ? 1.0f : 0.0f;
  }
}

template <int B>
cudaError_t launch(const float* jgg, const float* m0, float* w, float* dw,
                   float* a, const float* mu, const float* lam,
                   const float* lrho, const float* ua, const float* eps,
                   int G, int N, cudaStream_t s) {
  const int threads = 128;
  edge_scan_kernel<B><<<(N + threads - 1) / threads, threads, 0, s>>>(
      jgg, m0, w, dw, a, mu, lam, lrho, ua, eps, G, N);
  return cudaGetLastError();
}

}  // namespace

// jgg: (GB(GB+1)/2, N) packed within-group Gram; m0, w: (GB, N), w updated
// in place; dw: (GB, N) out; a: (G, N) out; mu: (G, N, B); lam: (G, N, B, B);
// lrho, ua: (G, N); eps: (G, N, B). All float32, contiguous.
extern "C" int ss_edge_scan_launch(const float* jgg, const float* m0,
                                   float* w, float* dw, float* a,
                                   const float* mu, const float* lam,
                                   const float* lrho, const float* ua,
                                   const float* eps, int G, int B, int N,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (G < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (B) {
#define PGT_CASE(b) \
  case b:           \
    return (int)launch<b>(jgg, m0, w, dw, a, mu, lam, lrho, ua, eps, G, N, s);
    PGT_CASE(1) PGT_CASE(2) PGT_CASE(3) PGT_CASE(4)
    PGT_CASE(5) PGT_CASE(6) PGT_CASE(7) PGT_CASE(8)
#undef PGT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
