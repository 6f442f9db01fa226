// K2: the streaming half of the collapsed spike-and-slab update, one launch
// per presyn group g = 0 .. Ng (g = Ng is the epilogue, scatter only):
//
//   u    -= omega * (X_{g-1}^T dW_{g-1})    (apply the previous group's draws)
//   M0    = X_g u                           (gather, GB x N)
//   Jgg   = X_g diag(omega) X_g^T           (within-group Gram, per lane n,
//                                            packed upper triangle p <= q)
//   sum_t omega                             (on request, at g = 0)
//
// Replaces the streaming part of pyglm_tpu/ops/ss_pallas.py::_make_kernel
// (resample_spike_slab_fused) and, with the same arithmetic, the per-group
// mesh kernel ss_pallas.py::_make_group_pass_kernel (ss_group_pass_pallas).
// The TPU kernel walks its grid in order and carries M0/Jgg in VMEM scratch
// from one time chunk to the next. Hopper blocks run in no order, so the
// time axis is split across blocks (split-K): each block owns a t-range and
// a 128-lane tile and writes its partial sums to a scratch buffer that the
// wrapper allocated; a second kernel sums the partials in a fixed order, so
// results repeat from run to run. No atomics.
//
// Bound on the H100: the Gram, ~GB(GB+1)/2 * N * T fp32 FMAs per group
// (1.1e10 at GB=32, N=200, T=1e5; 2.6e11 per sweep), plus three (T, N) f32
// streams (omega, u in, u out). Outputs are tiled 128 rows x 128 lanes over
// 256 threads, each holding an 8 x 8 register micro-tile fed from shared
// memory by four float4 loads per 64 FMAs; a warp whose rows all lie past
// the tile's valid rows skips the product. The Gram's left operand
// Z[pq, t] = X[p, t] X[q, t] is formed in shared memory and never stored.
// Each step's global loads are issued into registers during the previous
// step's product, so their latency is hidden. The first row tile handles
// M0 and the scatter; only it touches u, so u is updated in place with no
// race. fp32 FMA throughout ("high" and "highest"); tensor cores are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kRT = 128;    // output rows per tile
constexpr int kNT = 128;    // postsyn lanes per tile
constexpr int kKT = 16;     // time steps per shared-memory stage
constexpr int kThreads = 256;
constexpr int kMaxGB = 64;

__global__ void __launch_bounds__(kThreads, 2)
group_pass_kernel(const float* __restrict__ xg, const float* __restrict__ xp,
                  const float* __restrict__ om, float* __restrict__ u,
                  const float* __restrict__ dw, float* __restrict__ part,
                  int T, int N, int GB, int rows_per_split, int n_rows,
                  int want_sumom) {
  __shared__ float xs[kMaxGB][kKT + 1];
  __shared__ float xps[kMaxGB][kKT + 1];
  extern __shared__ float dws[];   // (GB, kNT), dynamic
  __shared__ __align__(16) float as[kKT][kRT];
  __shared__ __align__(16) float bs[kKT][kNT];
  __shared__ int pidx[kRT], qidx[kRT];
  __shared__ float red[kThreads / kNT][kNT];

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int lane0 = blockIdx.y * kNT;
  const int tile = blockIdx.z;
  const bool m0_tile = tile == 0;
  const bool gather = xg != nullptr;
  const bool scatter = m0_tile && xp != nullptr && dw != nullptr;
  const int npair = GB * (GB + 1) / 2;
  const int t_begin = split * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);

  if (!m0_tile && tid < kRT) {
    // Row pr of the packed triangle -> (p, q), row-major over p <= q.
    const int pr = (tile - 1) * kRT + tid;
    int p = -1, q = -1;
    if (pr < npair) {
      int rem = pr;
      p = 0;
      while (rem >= GB - p) {
        rem -= GB - p;
        ++p;
      }
      q = p + rem;
    }
    pidx[tid] = p;
    qidx[tid] = q;
  }
  if (scatter) {
    for (int i = tid; i < GB * kNT; i += kThreads) {
      const int r = i / kNT, l = i % kNT, n = lane0 + l;
      dws[r * kNT + l] = n < N ? dw[(size_t)r * N + n] : 0.0f;
    }
  }
  __syncthreads();

  // micro-tile: rows 8ty .. 8ty+7, lanes 4tx.. and 64+4tx.. (the split keeps
  // the float4 loads of a warp on distinct banks)
  const int tx = tid % 16, ty = tid / 16;
  const int ll = tid % kNT, lk = tid / kNT;    // staging: lane ll, steps lk + 2j
  const int n_ld = lane0 + ll;
  // Valid rows of this tile; ty pairs share a warp, so the test is uniform.
  const int tile_rows = m0_tile ? GB : min(kRT, npair - (tile - 1) * kRT);
  const bool busy = gather && 16 * (ty / 2) < tile_rows;
  float acc[8][8] = {};
  float sum_om = 0.0f;

  // Global loads for step t0 go to registers one step ahead, so their
  // latency overlaps the previous step's product.
  constexpr int kXPer = kMaxGB * kKT / kThreads;       // design values
  constexpr int kBPer = kKT / (kThreads / kNT);        // (t, lane) values
  float xr[kXPer], xpr[kXPer], omr[kBPer], ur[kBPer];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + kThreads * j, r = i / kKT, t = t0 + i % kKT;
      const bool ok = i < GB * kKT && t < t_end;
      xr[j] = (gather && ok) ? xg[(size_t)r * T + t] : 0.0f;
      xpr[j] = (scatter && ok) ? xp[(size_t)r * T + t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int t = t0 + lk + (kThreads / kNT) * j;
      const bool ok = t < t_end && n_ld < N;
      const size_t idx = (size_t)t * N + n_ld;
      omr[j] = ok ? om[idx] : 0.0f;
      ur[j] = (ok && m0_tile) ? u[idx] : 0.0f;
    }
  };
  prefetch(t_begin);

  for (int t0 = t_begin; t0 < t_end; t0 += kKT) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + kThreads * j;
      if (i < GB * kKT) {
        xs[i / kKT][i % kKT] = xr[j];
        xps[i / kKT][i % kKT] = xpr[j];
      }
    }
    __syncthreads();
    if (m0_tile) {
      for (int i = tid; i < kKT * kRT; i += kThreads) {
        const int k = i / kRT, r = i % kRT;
        as[k][r] = r < GB ? xs[r][k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBPer; ++j) {
        const int k = lk + (kThreads / kNT) * j, t = t0 + k;
        float uu = ur[j];
        if (scatter && t < t_end && n_ld < N) {
          float s = 0.0f;
#pragma unroll 8
          for (int r = 0; r < GB; ++r) s = fmaf(xps[r][k], dws[r * kNT + ll], s);
          uu -= omr[j] * s;
          u[(size_t)t * N + n_ld] = uu;
        }
        sum_om += omr[j];
        bs[k][ll] = uu;
      }
    } else {
      for (int i = tid; i < kKT * kRT; i += kThreads) {
        const int k = i / kRT, r = i % kRT, p = pidx[r];
        as[k][r] = p >= 0 ? xs[p][k] * xs[qidx[r]][k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBPer; ++j)
        bs[lk + (kThreads / kNT) * j][ll] = omr[j];
    }
    __syncthreads();
    if (t0 + kKT < t_end) prefetch(t0 + kKT);
    if (busy) {
#pragma unroll
      for (int k = 0; k < kKT; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[k][8 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[k][8 * ty + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + 4 * tx]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  if (!gather) return;

  float* pbase = part + (size_t)split * n_rows * N;
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * ty + i;
    int row;
    if (m0_tile) {
      if (r >= GB) continue;
      row = r;
    } else {
      const int pr = (tile - 1) * kRT + r;
      if (pr >= npair) continue;
      row = GB + pr;
    }
    for (int j = 0; j < 8; ++j) {
      const int n = lane0 + (j < 4 ? 0 : 60) + 4 * tx + j;
      if (n < N) pbase[(size_t)row * N + n] = acc[i][j];
    }
  }
  if (m0_tile && want_sumom) {
    red[lk][ll] = sum_om;
    __syncthreads();
    if (tid < kNT) {
      float s = 0.0f;
      for (int k = 0; k < kThreads / kNT; ++k) s += red[k][tid];
      const int n = lane0 + tid;
      if (n < N) pbase[(size_t)(GB + npair) * N + n] = s;
    }
  }
}

// out[i] = sum over splits of part[split, i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_split,
                                     long long stride, long long count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f;
  for (int k = 0; k < n_split; ++k) s += part[k * stride + i];
  out[i] = s;
}

}  // namespace

// xg, xp: (GB, T) design rows of groups g and g-1 (null when absent);
// om: (T, N); u: (T, N) updated in place; dw: (GB, N) or null;
// part: (n_split, GB + npair + 1, N) scratch; out: (GB + npair + 1, N) with
// rows [M0; packed Jgg; sum_t omega]. The last row is written only when
// want_sumom is set; nothing is written to out when xg is null.
extern "C" int ss_group_pass_launch(const float* xg, const float* xp,
                                    const float* om, float* u,
                                    const float* dw, float* part, float* out,
                                    int T, int N, int GB, int n_split,
                                    int want_sumom, void* stream) {
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int npair = GB * (GB + 1) / 2;
  const int n_rows = GB + npair + 1;
  int rows = (T + n_split - 1) / n_split;
  rows = (rows + kKT - 1) / kKT * kKT;
  const bool gather = xg != nullptr;
  dim3 grid(n_split, (N + kNT - 1) / kNT,
            gather ? 1 + (npair + kRT - 1) / kRT : 1);
  // dW of the scatter lives in dynamic shared memory, GB x kNT floats.
  const int dyn = GB * kNT * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxGB * kNT * (int)sizeof(float));
  if (attr != cudaSuccess) return (int)attr;
  group_pass_kernel<<<grid, kThreads, dyn, s>>>(xg, xp, om, u, dw, part, T, N,
                                              GB, rows, n_rows, want_sumom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !gather) return (int)err;
  const long long count = (long long)(GB + npair + (want_sumom ? 1 : 0)) * N;
  const int threads = 256;
  reduce_splits_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                         0, s>>>(part, out, n_split, (long long)n_rows * N,
                                 count);
  return (int)cudaGetLastError();
}
