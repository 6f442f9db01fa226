// K6: the omega-weighted within-group Gram blocks of every presyn group, in
// one launch:
//
//   Jg[g, pq, n] = sum_t X[gGB + p, t] X[gGB + q, t] omega[t, n],  p <= q
//
// stored as the packed upper triangle (Ng, GB(GB+1)/2, N), row-major over
// p <= q (``torch.triu_indices``), so the edge scan K3 takes Jg[g] as it
// takes K2's packed Gram, with no copy.
//
// Replaces pyglm_tpu/ops/gram_pallas.py::group_gram_blocks_pallas_t (and
// group_gram_blocks_pallas, which calls it) with both its bodies: the f32
// body _gram_kernel_f32 (bf16x3 on the TPU) and the single-bf16-pass body
// _gram_kernel_fast (fast=True, precision "default"). The TPU kernel
// carries a full GB x GB output block in VMEM across an ordered time-chunk
// grid axis. Hopper blocks run in no order, so each block owns one (group,
// pair-row tile, lane tile) and loops over all of T inside itself; nothing
// is carried between blocks and no atomics are used, so results repeat
// from run to run. Only the triangle p <= q is formed: half the products
// of the TPU kernel's GB x GB block (820 pairs instead of 1600 at GB = 40).
//
// Three bodies, chosen by the caller's precision:
//   - "high": group_gram_tc_kernel<kTf32x3>, 3xTF32 on the tensor cores with
//     the tile loop shared with K2 (gram_tc.cuh): cp.async ring, Z = X_p X_q
//     formed once per stage in shared memory, fragments past the last pair
//     row or lane skipped, the fp32 accumulators folded every 128 steps
//     into a second fp32 sum (two-level, so no accumulator sums 2e4 terms).
//     Bound: 3 x 2 x 3.3e12 FLOP at config 5 over the 495 TFLOP/s TF32 peak.
//   - "default": group_gram_tc_kernel<kBf16>, the same loop with Z and
//     omega rounded to bf16 in registers and one bf16 mma.sync per fragment
//     pair (_gram_kernel_fast rounds both inside the kernel too). Bound: 2 x
//     3.3e12 FLOP over the 989 TFLOP/s bf16 peak, ~6.7 ms.
//   - "highest": group_gram_kernel, fp32 FMA on the CUDA cores (the JAX
//     package's "highest" takes its f32 XLA Gram, which sums per 512-step
//     chunk in a lax.scan). 128 pair rows x 128 lanes over 256 threads, each
//     an 8 x 8 register micro-tile fed from shared memory by four float4
//     loads per 64 FMAs; Z formed in shared memory; each step's global loads
//     issued into registers during the previous step's product; a warp
//     whose rows all lie past the last pair row skips the product. Every
//     512 steps the registers are folded by Fast2Sum into a second fp32 sum
//     kept in shared memory (so 2e4 terms are never summed in one fp32
//     accumulator). Bound: 6.6e12 FLOP over the 67 TFLOP/s fp32 peak.
// The grid is ~11k-21k blocks at the 8-chain ensemble (Ng = 50, GB = 40,
// 4000 lanes, T = 2e4), so there is no split of the time axis. The ragged T
// edge is masked in the loads (X and omega read as 0 past T).

#include <cuda_runtime.h>

#include "gram_tc.cuh"

namespace {

constexpr int kRT = 128;    // pair rows per tile
constexpr int kNT = 128;    // postsyn lanes per tile
constexpr int kKT = 16;     // time steps per shared-memory stage
constexpr int kThreads = 256;
constexpr int kMaxGB = 64;
// Tile-loop stages per fold (128 steps; 48 truncated adds per chunk at
// 3xTF32): 64 steps halve the Gram's error and cost ~10% more time
// (PERF.md).
constexpr int kFold = 4;
// The fp32 body's stages per fold (512 steps, the JAX Gram's chunk), and
// the shared memory of its second sum: 64 floats per thread.
constexpr int kFoldFp32 = 512 / kKT;
constexpr int kSumBytes = 64 * kThreads * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
group_gram_kernel(const float* __restrict__ xt, const float* __restrict__ om,
                  float* __restrict__ out, int T, int N, int GB) {
  __shared__ float xs[kMaxGB][kKT + 1];
  __shared__ __align__(16) float as[kKT][kRT];
  __shared__ __align__(16) float bs[kKT][kNT];
  __shared__ int pidx[kRT], qidx[kRT];
  extern __shared__ float sums[];    // [64][kThreads]: the second sums

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kNT;
  const int tile = blockIdx.y;
  const int g = blockIdx.z;
  const int npair = GB * (GB + 1) / 2;
  const float* xg = xt + (size_t)g * GB * T;

  if (tid < kRT) {
    // Row pr of the packed triangle -> (p, q), row-major over p <= q.
    const int pr = tile * kRT + tid;
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
  __syncthreads();

  // micro-tile: rows 8ty .. 8ty+7, lanes 4tx.. and 64+4tx.. (the split keeps
  // the float4 loads of a warp on distinct banks)
  const int tx = tid % 16, ty = tid / 16;
  const int ll = tid % kNT, lk = tid / kNT;    // staging: lane ll, steps lk + 2j
  const int n_ld = lane0 + ll;
  // Valid rows of this tile; ty pairs share a warp, so the test is uniform.
  const int tile_rows = min(kRT, npair - tile * kRT);
  const bool busy = 16 * (ty / 2) < tile_rows;
  float acc[8][8] = {};
#pragma unroll
  for (int e = 0; e < 64; ++e) sums[e * kThreads + tid] = 0.0f;

  constexpr int kXPer = kMaxGB * kKT / kThreads;       // design values
  constexpr int kBPer = kKT / (kThreads / kNT);        // (t, lane) values
  float xr[kXPer], omr[kBPer];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + kThreads * j, r = i / kKT, t = t0 + i % kKT;
      xr[j] = (i < GB * kKT && t < T) ? xg[(size_t)r * T + t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int t = t0 + lk + (kThreads / kNT) * j;
      omr[j] = (t < T && n_ld < N) ? om[(size_t)t * N + n_ld] : 0.0f;
    }
  };
  prefetch(0);

  for (int t0 = 0, stage = 1; t0 < T; t0 += kKT, ++stage) {
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + kThreads * j;
      if (i < GB * kKT) xs[i / kKT][i % kKT] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) bs[lk + (kThreads / kNT) * j][ll] = omr[j];
    __syncthreads();
    for (int i = tid; i < kKT * kRT; i += kThreads) {
      const int k = i / kRT, r = i % kRT, p = pidx[r];
      as[k][r] = p >= 0 ? xs[p][k] * xs[qidx[r]][k] : 0.0f;
    }
    __syncthreads();
    if (t0 + kKT < T) prefetch(t0 + kKT);
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
      if (stage % kFoldFp32 == 0) {
        // sum + acc = t + e exactly (Fast2Sum, as in gram_tc.cuh): sum
        // takes t, and the rounding error e seeds the next chunk.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* sp = sums + (8 * i + j) * kThreads + tid;
            const float a = *sp, b = acc[i][j], t = a + b;
            *sp = t;
            acc[i][j] = b - (t - a);
          }
      }
    }
    __syncthreads();
  }

  float* obase = out + (size_t)g * npair * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pr = tile * kRT + 8 * ty + i;
    if (pr >= npair) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = lane0 + (j < 4 ? 0 : 60) + 4 * tx + j;
      if (n < N)
        obase[(size_t)pr * N + n] = sums[(8 * i + j) * kThreads + tid] +
                                    acc[i][j];
    }
  }
}

// "high" (kTf32x3) and "default" (kBf16) on the tensor cores, one tile of
// one group per block.
template <int kMode>
__global__ void __launch_bounds__(gram_tc::kThreads, 2)
group_gram_tc_kernel(const float* __restrict__ xt, const float* __restrict__ om,
                     float* __restrict__ out, int T, int N, int GB, int vec_x,
                     int vec_o) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.z, npair = GB * (GB + 1) / 2;
  gram_tc::gram_tile<kMode>(xt + (size_t)g * GB * T, T, GB, true, om, N, 0,
                            T, blockIdx.x * gram_tc::kNT,
                            blockIdx.y * gram_tc::kMT, npair, vec_x, vec_o,
                            kFold, 0, 0, out + (size_t)g * npair * N, smem);
}

template <int kMode>
cudaError_t launch_tc(const float* xt, const float* om, float* out, int T,
                      int N, int GB, int Ng, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_gram_tc_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_tc::smem_floats(gram_tc::kMaxGB) * (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  const int npair = GB * (GB + 1) / 2;
  const int vec_x = T % 4 == 0 && (size_t)xt % 16 == 0;
  const int vec_o = N % 4 == 0 && (size_t)om % 16 == 0;
  dim3 grid((N + gram_tc::kNT - 1) / gram_tc::kNT,
            (npair + gram_tc::kMT - 1) / gram_tc::kMT, Ng);
  group_gram_tc_kernel<kMode>
      <<<grid, gram_tc::kThreads, gram_tc::smem_floats(GB) * (int)sizeof(float),
         s>>>(xt, om, out, T, N, GB, vec_x, vec_o);
  return cudaGetLastError();
}

}  // namespace

// xt: (>= Ng GB, T) design rows, group g in rows [g GB, (g + 1) GB);
// om: (T, N); out: (Ng, GB(GB+1)/2, N), every element written. body: 0 the
// fp32 FMA body ("highest"), 1 the 3xTF32 body ("high"), 2 the bf16 body
// ("default").
extern "C" int group_gram_launch(const float* xt, const float* om, float* out,
                                 int T, int N, int GB, int Ng, int body,
                                 void* stream) {
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || Ng < 1 || Ng > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int npair = GB * (GB + 1) / 2;
  switch (body) {
    case 0: {
      static const cudaError_t attr = cudaFuncSetAttribute(
          group_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSumBytes);
      if (attr != cudaSuccess) return (int)attr;
      dim3 grid((N + kNT - 1) / kNT, (npair + kRT - 1) / kRT, Ng);
      group_gram_kernel<<<grid, kThreads, kSumBytes, s>>>(xt, om, out, T, N,
                                                          GB);
      return (int)cudaGetLastError();
    }
    case 1:
      return (int)launch_tc<gram_tc::kTf32x3>(xt, om, out, T, N, GB, Ng, s);
    case 2:
      return (int)launch_tc<gram_tc::kBf16>(xt, om, out, T, N, GB, Ng, s);
  }
  return (int)cudaErrorInvalidValue;
}
