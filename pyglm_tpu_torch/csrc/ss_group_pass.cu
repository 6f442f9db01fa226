// K2: the streaming half of the collapsed spike-and-slab update, one call
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
// mesh kernel ss_pallas.py::_make_group_pass_kernel (ss_group_pass_pallas),
// in all three of their Gram modes. The TPU kernel walks its grid in order
// and carries M0/Jgg in VMEM scratch from one time chunk to the next. Hopper
// blocks run in no order, so the time axis is split across blocks
// (split-K): each block owns a t-range and writes its partial sums to a
// scratch buffer that the wrapper allocated; copy_reduce::reduce_splits
// sums the partials in a fixed order, so results repeat from run to run. No atomics.
//
// The Gram's mode is the caller's precision, as the TPU kernel's `gram`:
// "high" 3xTF32 (bf16x3 there) on the mma.sync tile loop of gram_tc.cuh;
// "default" one bf16 pass (gram == "bf16", :343-345) and "sr" one bf16
// pass on a stochastically rounded Z (gram == "sr", :346-347, with the
// rounding of _sr16), both on the wgmma tile of gram_wgmma.cuh over a bf16
// omega stream that the caller rounds once per update (the TPU kernel
// streams omega as bf16 there, ss_pallas.py:409-413). M0 stays 3xTF32 and
// the scatter fp32 in every mode, as the TPU kernel keeps them f32-grade
// (_mm3); at "default" and "sr" the caller's fp32 omega holds the same
// bf16 values. Kernels:
//   - scatter_kernel: u -= omega (X_p^T dW) and sum_t omega in fp32 FMA (u
//     carries the residual across all groups, so its update stays fp32);
//     one thread per postsyn lane with dW in registers, u and omega
//     streamed through shared memory by cp.async; memory-bound, in place;
//   - gram_tc_kernel (gram_tc.cuh, the tile loop shared with K6's "high"
//     body): M0 = X_g u (Z = X_g) in every mode, and the packed Gram of
//     omega (Z = X_p X_q formed in shared memory, never stored) at "high";
//   - group_pass_wgmma_kernel<kSr> (gram_wgmma.cuh, the tile of K6's
//     "default" body at kK2NP = 176 pair rows): the packed Gram at
//     "default" and "sr", a block per (split of T, tile of 176 pair rows,
//     tile of 128 lanes). GB = 32's 528 pairs are 3 tiles with no padding
//     (4 of K6's 168 rows hold 672, and the 4 x 2 tiles per split left
//     room for 16 splits where 3 x 2 take 22: 132 blocks of ~72 stages
//     instead of 128 of ~98). Its splits are whole 64-step stages, so every
//     split starts on a stage and on an 8-step Philox chunk (the SR words
//     of (t / 8, pr) are the same for every tile and split), and as many
//     as fill one wave at one block per SM.
// The Gram needs only omega, so it runs on the caller's stream beside the
// scatter and then M0 on a side stream.
//
// Bound on the H100: at "high" the Gram, GB(GB+1)/2 * N * T FMAs per group
// (1.06e10 at GB=32, N=200, T=1e5), as three TF32 tensor-core products each,
// over 495 TFLOP/s. At "default" and "sr" the Gram's one bf16 pass over 989
// TFLOP/s is ~0.021 ms, its bf16 omega 0.012 ms at 3.35 TB/s, and the call
// turns bound by its bytes (u read and written by the scatter and read by
// M0, omega read twice: ~0.1 ms).

#include <cuda_runtime.h>

#include "copy_reduce.cuh"
#include "gram_tc.cuh"
#include "gram_wgmma.cuh"

namespace {

constexpr int kLanes = 128;  // scatter: one thread per postsyn lane
constexpr int kCh = 16;      // time steps per chunk
constexpr int kMaxGB = 64;
constexpr int kMaxDevices = 16;
// Pair rows per tile of the wgmma Gram: GB = 32's 528 pairs are 3 tiles
// (the flagship group; 2 x 176 fp32 sums per thread, 255 registers).
constexpr int kK2NP = 176;
// 3xTF32 tile-loop stages per fold (128 steps), as in K6 (group_gram.cu).
constexpr int kFold = 4;

template <int R>
constexpr int scatter_smem_bytes() {
  return 4 * (2 * R * kCh + 4 * kCh * kLanes);
}

// u[t, n] -= omega[t, n] sum_r X_p[r, t] dW[r, n] (each sum over r in
// order) when xp is given, and the split partial of sum_t omega[t, n] when
// want_sumom is set. dW of a thread's lane lives in registers (R >= GB).
// X_p, omega and u come through shared memory kCh steps at a time,
// double-buffered by cp.async so that the next chunk streams in while this
// one is computed; X_p is read as float4 over 4 steps, so each shared load
// feeds 4 FMAs.
template <int R>
__global__ void __launch_bounds__(kLanes)
scatter_kernel(const float* __restrict__ xp, const float* __restrict__ om,
               float* __restrict__ u, const float* __restrict__ dw,
               float* __restrict__ part, int T, int N, int GB,
               int rows_per_split, int want_sumom) {
  extern __shared__ __align__(16) float sm[];
  float* xps = sm;                        // [2][R][kCh]
  float* oms = xps + 2 * R * kCh;         // [2][kCh][kLanes]
  float* us = oms + 2 * kCh * kLanes;     // [2][kCh][kLanes]
  const int tid = threadIdx.x;
  const int n = blockIdx.y * kLanes + tid;
  const bool lane_ok = n < N;
  const bool scatter = xp != nullptr;
  const int t_begin = blockIdx.x * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  const int nch = t_end > t_begin ? (t_end - t_begin + kCh - 1) / kCh : 0;

  auto load_chunk = [&](int c) {
    const int t0 = t_begin + c * kCh, buf = c & 1;
    if (scatter) {
      for (int i = tid; i < GB * kCh; i += kLanes) {
        const int r = i / kCh, k = i % kCh, t = t0 + k;
        const bool ok = t < t_end;
        copy_reduce::cp_async4(xps + (buf * R + r) * kCh + k,
                               ok ? xp + (size_t)r * T + t : xp, ok);
      }
    }
#pragma unroll
    for (int k = 0; k < kCh; ++k) {
      const int t = t0 + k;
      const bool ok = t < t_end && lane_ok;
      const size_t g = ok ? (size_t)t * N + n : 0;
      const int o = (buf * kCh + k) * kLanes + tid;
      copy_reduce::cp_async4(oms + o, om + g, ok);
      if (scatter) copy_reduce::cp_async4(us + o, u + g, ok);
    }
  };

  float d[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    d[r] = (scatter && r < GB && lane_ok) ? dw[(size_t)r * N + n] : 0.0f;
  float sum_om = 0.0f;

  if (nch > 0) load_chunk(0);
  copy_reduce::cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load_chunk(c + 1);
    copy_reduce::cp_async_commit();
    copy_reduce::cp_async_wait<1>();
    __syncthreads();
    const int t0 = t_begin + c * kCh, buf = c & 1;
    const float* xpb = xps + buf * R * kCh;
#pragma unroll
    for (int k = 0; k < kCh; k += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = oms[(buf * kCh + k + i) * kLanes + tid];
      sum_om += (w[0] + w[1]) + (w[2] + w[3]);
      if (!scatter) continue;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < GB) {
          const float4 a = *reinterpret_cast<const float4*>(xpb + r * kCh + k);
          sc[0] = fmaf(a.x, d[r], sc[0]);
          sc[1] = fmaf(a.y, d[r], sc[1]);
          sc[2] = fmaf(a.z, d[r], sc[2]);
          sc[3] = fmaf(a.w, d[r], sc[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + k + i;
        const float uu = us[(buf * kCh + k + i) * kLanes + tid];
        if (t < t_end && lane_ok) u[(size_t)t * N + n] = uu - w[i] * sc[i];
      }
    }
    __syncthreads();   // the next load refills this chunk's buffers
  }
  copy_reduce::cp_async_wait<0>();
  if (want_sumom && lane_ok) part[(size_t)blockIdx.x * N + n] = sum_om;
}

// One 3xTF32 tile loop per block over its split of T: the packed Gram
// X_g diag(B) X_g^T (pairs = 1, B = omega) or X_g B (pairs = 0, B = u), as
// (n_split, n_rows, N) partials.
__global__ void __launch_bounds__(gram_tc::kThreads, 2)
gram_tc_kernel(const float* __restrict__ xg, const float* __restrict__ b,
               float* __restrict__ part, int T, int N, int GB, int pairs,
               int n_rows, int rows_per_split, int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.x;
  const int t_begin = split * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  gram_tc::gram_tile(xg, T, GB, pairs, b, N, t_begin, t_end,
                     blockIdx.y * gram_tc::kNT, blockIdx.z * gram_tc::kMT,
                     n_rows, vec_x, vec_b, kFold,
                     part + (size_t)split * n_rows * N, smem);
}

// The bf16 Gram ("default") or the SR Gram ("sr", kSr) of omega on wgmma
// (gram_wgmma.cuh): block (split, pair tile, lane tile) forms its tile's
// partial over its split of T, rows_per_split steps (a multiple of the
// 64-step stage) from split * rows_per_split, at part[split].
template <bool kSr>
__global__ void __launch_bounds__(gram_wgmma::kThreads, 1)
group_pass_wgmma_kernel(const float* __restrict__ xg,
                        const uint16_t* __restrict__ om16,
                        const uint16_t* __restrict__ pq,
                        float* __restrict__ part, int T, int N, int N8,
                        int GB, int rows_per_split, int vec_x,
                        unsigned long long seed, unsigned long long offset) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int npair = GB * (GB + 1) / 2, split = blockIdx.x;
  const int row0 = blockIdx.y * kK2NP;
  const int t_begin = split * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  gram_wgmma::gram_tile<kK2NP, kSr>(
      xg, T, GB, vec_x, om16, N8, N, t_begin, t_end,
      blockIdx.z * gram_wgmma::kLT, pq + row0,
      min(kK2NP, npair - row0),
      part + ((size_t)split * npair + row0) * N, N, smem_raw, row0, seed,
      offset);
}

template <int R>
cudaError_t launch_scatter_r(const float* xp, const float* om, float* u,
                             const float* dw, float* part, int T, int N,
                             int GB, int n_split, int want_sumom,
                             cudaStream_t s) {
  const int rows = (T + n_split - 1) / n_split;
  scatter_kernel<R><<<dim3(n_split, (N + kLanes - 1) / kLanes), kLanes,
                      scatter_smem_bytes<R>(), s>>>(xp, om, u, dw, part, T, N,
                                                    GB, rows, want_sumom);
  return cudaGetLastError();
}

cudaError_t launch_scatter(const float* xp, const float* om, float* u,
                           const float* dw, float* part, int T, int N, int GB,
                           int n_split, int want_sumom, cudaStream_t s) {
  if (GB <= 16)
    return launch_scatter_r<16>(xp, om, u, dw, part, T, N, GB, n_split,
                                want_sumom, s);
  if (GB <= 32)
    return launch_scatter_r<32>(xp, om, u, dw, part, T, N, GB, n_split,
                                want_sumom, s);
  return launch_scatter_r<64>(xp, om, u, dw, part, T, N, GB, n_split,
                              want_sumom, s);
}

cudaError_t launch_tc(const float* xg, const float* b, float* part, int T,
                      int N, int GB, int pairs, int n_split, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gram_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_tc::smem_floats(gram_tc::kMaxGB) * (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  const int n_rows = pairs ? GB * (GB + 1) / 2 : GB;
  int rows = (T + n_split - 1) / n_split;
  rows = (rows + gram_tc::kKT - 1) / gram_tc::kKT * gram_tc::kKT;
  const int vec_x = T % 4 == 0 && (size_t)xg % 16 == 0;
  const int vec_b = N % 4 == 0 && (size_t)b % 16 == 0;
  gram_tc_kernel
      <<<dim3(n_split, (N + gram_tc::kNT - 1) / gram_tc::kNT,
              (n_rows + gram_tc::kMT - 1) / gram_tc::kMT),
         gram_tc::kThreads, gram_tc::smem_floats(GB) * (int)sizeof(float),
         s>>>(xg, b, part, T, N, GB, pairs, n_rows, rows, vec_x, vec_b);
  return cudaGetLastError();
}

template <bool kSr>
cudaError_t launch_wgmma(const float* xg, const uint16_t* om16,
                         const uint16_t* pq, float* part, int T, int N,
                         int N8, int GB, int n_split, int ntile,
                         unsigned long long seed, unsigned long long offset,
                         cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_pass_wgmma_kernel<kSr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_wgmma::smem_bytes<kK2NP>(gram_wgmma::kMaxGB));
  if (attr != cudaSuccess) return attr;
  int rows = (T + n_split - 1) / n_split;
  rows = (rows + gram_wgmma::kKS - 1) / gram_wgmma::kKS * gram_wgmma::kKS;
  const int vec_x = T % 4 == 0 && (size_t)xg % 16 == 0;
  group_pass_wgmma_kernel<kSr>
      <<<dim3(n_split, ntile, (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT),
         gram_wgmma::kThreads, gram_wgmma::smem_bytes<kK2NP>(GB), s>>>(
          xg, om16, pq, part, T, N, N8, GB, rows, vec_x, seed, offset);
  return cudaGetLastError();
}

// The packed Gram of omega in the caller's mode: om (fp32) at "high", om16
// (bf16) and the pair table pq at "default" and "sr".
cudaError_t launch_gram(const float* xg, const float* om,
                        const uint16_t* om16, const uint16_t* pq, float* part,
                        int T, int N, int N8, int GB, int n_split, int ntile,
                        int gram, unsigned long long seed,
                        unsigned long long offset, cudaStream_t s) {
  switch (gram) {
    case 0:
      return launch_tc(xg, om, part, T, N, GB, 1, n_split, s);
    case 1:
      return launch_wgmma<false>(xg, om16, pq, part, T, N, N8, GB, n_split,
                                 ntile, 0, 0, s);
    case 2:
      return launch_wgmma<true>(xg, om16, pq, part, T, N, N8, GB, n_split,
                                ntile, seed, offset, s);
  }
  return cudaErrorInvalidValue;
}

// A side stream and its fork/join events for each device, made at first use.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

cudaError_t side_for_current_device(Side** out) {
  static Side sides[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (sd.stream == nullptr) {
    if ((err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming)) !=
            cudaSuccess)
      return err;
  }
  *out = &sd;
  return cudaSuccess;
}

}  // namespace

// xg, xp: (GB, T) design rows of groups g and g-1 (null when absent);
// om: (T, N); u: (T, N) updated in place; dw: (GB, N) or null. At
// "default" and "sr" (gram 1, 2) with xg given: om16, omega rounded to
// bf16, (T, N8) with N8 >= N a multiple of 8 and lanes past N zero; pq,
// ntile x kNP pair-table entries p | q << 8 (0xFFFF past the last pair
// row), row-major over p <= q. Scratch: part_g (n_split, GB(GB+1)/2, N),
// part_m (n_split_m, GB, N) and part_s (n_split_s, N). out: (GB + npair +
// 1, N) with rows [M0; packed Jgg; sum_t omega]; the last row is written
// only when want_sumom is set, and nothing is written to out when xg is
// null (the epilogue). gram: the Gram's mode (0 "high", 1 "default", 2
// "sr"); seed and offset select the Philox words of "sr"'s rounding.
extern "C" int ss_group_pass_launch(const float* xg, const float* xp,
                                    const float* om, const void* om16,
                                    const void* pq, float* u,
                                    const float* dw, float* part_g,
                                    float* part_m, float* part_s, float* out,
                                    int T, int N, int N8, int GB, int n_split,
                                    int n_split_m, int n_split_s, int ntile,
                                    int want_sumom, int gram,
                                    unsigned long long seed,
                                    unsigned long long offset, void* stream) {
  const int npair = GB * (GB + 1) / 2;
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || n_split < 1 ||
      n_split_m < 1 || n_split_s < 1 || gram < 0 || gram > 2)
    return (int)cudaErrorInvalidValue;
  if (gram != 0 && xg != nullptr &&
      (om16 == nullptr || (size_t)om16 % 16 != 0 || pq == nullptr ||
       N8 < N || N8 % 8 != 0 || ntile < 1 ||
       (ntile - 1) * kK2NP >= npair || ntile * kK2NP < npair ||
       n_split > 65535 ||
       (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool scatter = xp != nullptr && dw != nullptr;
  want_sumom = want_sumom && xg != nullptr;
  if (xg == nullptr)      // the epilogue: the scatter alone
    return (int)(scatter ? launch_scatter(xp, om, u, dw, part_s, T, N, GB,
                                          n_split_s, 0, s)
                         : cudaSuccess);

  // Side stream: the scatter (memory-bound), then M0 = X_g u. Caller's
  // stream: the Gram of omega (tensor-bound), then the reductions, after
  // both.
  Side* sd = nullptr;
  cudaError_t err = side_for_current_device(&sd);
  if (err != cudaSuccess ||
      (err = cudaEventRecord(sd->fork, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(sd->stream, sd->fork, 0)) != cudaSuccess)
    return (int)err;
  if ((scatter || want_sumom) &&
      (err = launch_scatter(scatter ? xp : nullptr, om, u, dw, part_s, T, N,
                            GB, n_split_s, want_sumom, sd->stream)) !=
          cudaSuccess)
    return (int)err;
  if ((err = launch_tc(xg, u, part_m, T, N, GB, 0, n_split_m,
                       sd->stream)) != cudaSuccess ||
      (err = cudaEventRecord(sd->join, sd->stream)) != cudaSuccess ||
      (err = launch_gram(xg, om, (const uint16_t*)om16,
                         (const uint16_t*)pq, part_g, T, N, N8, GB, n_split,
                         ntile, gram, seed, offset, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(s, sd->join, 0)) != cudaSuccess)
    return (int)err;

  // out = [M0; Jgg; sum omega], each summed over its splits in order.
  using copy_reduce::reduce_splits;
  if ((err = reduce_splits(part_m, out, n_split_m, (long long)GB * N,
                           (long long)GB * N, s)) != cudaSuccess ||
      (err = reduce_splits(part_g, out + (size_t)GB * N, n_split,
                           (long long)npair * N, (long long)npair * N, s)) !=
          cudaSuccess)
    return (int)err;
  if (want_sumom)
    err = reduce_splits(part_s, out + (size_t)(GB + npair) * N, n_split_s, N,
                        N, s);
  return (int)err;
}
