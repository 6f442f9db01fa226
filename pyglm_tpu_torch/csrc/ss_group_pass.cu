// K2: the streaming half and the Gram of the collapsed spike-and-slab
// update, one call per presyn group g = 0 .. Ng (g = Ng is the epilogue,
// scatter only):
//
//   u    -= omega * (X_{g-1}^T dW_{g-1})    (apply the previous group's draws)
//   M0    = X_g u                           (gather from the updated u, GB x N)
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
// sums the partials in a fixed order, so results repeat from run to run. No
// atomics. Two kernels a call:
//
//   - stream_pass_kernel<R, Om, kScatter, kGather>: the scatter and the
//     gather in one pass over u, as the TPU kernel does them on one chunk
//     while it sits in VMEM (u_new = u - om32 * _mm3_t(xp, dw), then m0 +=
//     _mm3(xg, u_new): ss_pallas.py:322-332, and :532-539 in the mesh
//     kernel; _mm3 and _mm3_t at :128-140, bf16x3 products of f32 grade).
//     Here both run in fp32 FMA, in every mode: the scatter in the fmaf
//     order of the kernel it replaced (so u is that kernel's bit for bit)
//     and M0 = sum_t X_g[r, t] u_new[t, n] as fp32 FMAs in t order (more
//     accurate than 3xTF32). u is read once and written once a call;
//     sum_t omega comes from the same pass.
//   - the packed Gram of omega in the caller's mode, as the TPU kernel's
//     `gram`: "high" 3xTF32 (bf16x3 there, _mm3 at :349) on the wgmma tile
//     of gram_wgmma.cuh in its TF32 mode (gram_tile_tf32) on the fp32
//     omega; "default" one bf16 pass (gram == "bf16", :343-345) and "sr"
//     one bf16 pass on a stochastically rounded Z (gram == "sr", :346-347,
//     with the rounding of _sr16), both on the wgmma tile of gram_wgmma.cuh
//     over a bf16 omega stream that the caller rounds once per update (the
//     TPU kernel streams omega as bf16 there, ss_pallas.py:409-413). At
//     "default" and "sr" the streaming pass reads that stream too, widened
//     to fp32 in registers, as the TPU kernel reads its one bf16 omega
//     (om32 = om_raw.astype(f32), :523-527).
//
// The streaming pass. A block covers (a split of T, a tile of W <= 256
// lanes); a thread serves L lanes (2 at GB <= 32, 1 above) and keeps each
// lane's dW column (R >= GB values) and its R partial sums of M0 in
// registers. Per chunk of kCh = 16 steps the block copies, by cp.async into
// a ring of kStages chunks (two in flight while one is computed), the
// chunk's X_p and X_g rows (read back as float4 broadcasts: one shared load
// feeds 4 steps x L lanes of FMAs), u and omega (fp32 at "high"; the bf16
// stream otherwise, in 16-byte runs of 8 lanes). Per group of
// kGrp = 8 steps: sc = sum_r X_p[r, t] dW[r, n] over r in order (8 L
// independent sums), u_new = u - omega sc, stored once, then M0[r] +=
// X_g[r, t] u_new. The rows past GB are zero in shared memory and in dW,
// so the loops over r run all R rows with no test. The mode is a template
// argument: g = 0 (the gather alone, with sum_t omega), the middle groups
// (both) and the epilogue (the scatter alone). The split plan
// (ops/ss_cuda.py::stream_pass_plan) fills one wave of blocks at the
// residency that shared memory and __launch_bounds__ allow, the same plan
// in every mode, so that u, M0 and sum_t omega at "default" and "sr" equal
// those of "high" on the rounded omega bit for bit.
//
// What sets its pace (H100, the flagship group, time_group_pass.py): the
// arithmetic's latency, not the bytes. Its copies alone take 0.063 ms at
// "default" (no u written); the scatter adds ~0.09 ms and the gather
// ~0.04 with a thread a lane and a test per row (0.22 ms in all). Two lanes
// a thread with no test per row and 8-step groups (more independent sums a
// thread) brought it to 0.156 ms; one lane a thread with 8-step groups
// spills at its 128-register cap, and a per-row test kept the loads of the
// next row from starting early (+20%). Two lanes a thread halves the
// shared loads per FMA but not the time, so shared memory does not pace it.
//
// Bound on the H100 at the flagship group (GB = 32, T = 1e5, N = 200):
//   - the streaming pass moves X_p and X_g (25.6 MB), u in and out (160
//     MB) and omega (80 MB fp32 at "high": 266 MB, 0.079 ms at 3.35 TB/s;
//     40 MB as the bf16 stream at "default" and "sr": 226 MB, 0.067 ms),
//     and does 2 GB T N = 1.28e9 fp32 FMAs (0.038 ms at 67 TFLOP/s): it is
//     bound by its bytes;
//   - the Gram at "high", GB(GB+1)/2 * N * T FMAs (1.06e10), as three TF32
//     tensor-core products each over 495 TFLOP/s: 0.128 ms; at "default"
//     and "sr" one bf16 pass over 989 TFLOP/s, ~0.021 ms, and its bf16
//     omega 0.012 ms at 3.35 TB/s.
// The pass runs on a side stream beside the Gram in every mode. A Gram
// block takes a whole SM's registers, so the two share the card poorly;
// still, on an H100 at the flagship group, running them one after the
// other on the caller's stream was no faster at "default" and "sr" and
// ~3% slower at "high", where the Gram's one wave of 128 blocks leaves SMs
// free (PERF.md).

#include <cuda_runtime.h>

#include "copy_reduce.cuh"
#include "gram_wgmma.cuh"

namespace {

constexpr int kMaxLanes = 256;  // streaming pass: lanes per block at most
constexpr int kCh = 16;         // ... time steps per chunk
constexpr int kStages = 3;      // ... chunks in its cp.async ring
constexpr int kGrp = 8;         // ... steps whose scatter sums run together
constexpr int kMaxGB = 64;
constexpr int kMaxDevices = 16;
// Pair rows per tile of the wgmma Gram: GB = 32's 528 pairs are 3 tiles
// (the flagship group; 2 x 176 fp32 sums per thread, 255 registers).
constexpr int kK2NP = 176;
// ... of the 3xTF32 Gram ("high"): 4 tiles of 136 (544 rows); its A
// fragments take 32 registers more per thread than the bf16 body's.
constexpr int kK2Tf32NP = 136;

// Lanes a thread of the streaming pass serves: a thread keeps 2 R L values
// in registers (dW and M0's sums for each of its lanes).
template <int R>
__host__ __device__ constexpr int lanes_per_thread() {
  return R <= 32 ? 2 : 1;
}

// Shared memory of a streaming-pass block of W lanes at R design rows: X_p
// and X_g [kStages][R][kCh] and u [kStages][kCh][W] in fp32, omega
// [kStages][kCh][W] in its own type.
template <int R, typename Om>
constexpr int stream_smem_bytes(int W) {
  return kStages * kCh * (4 * 2 * R + (4 + (int)sizeof(Om)) * W);
}

__device__ __forceinline__ float widen(uint16_t x) {   // bf16 -> fp32, exact
  return __uint_as_float((unsigned)x << 16);
}

// v = p[0 .. L), widened to fp32, in one shared load (p aligned to L
// elements; L is 1 or 2).
template <int L>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[L]) {
  if constexpr (L == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int L>
__device__ __forceinline__ void load_lanes(const uint16_t* p,
                                           float (&v)[L]) {
  if constexpr (L == 2) {
    const unsigned x = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(x << 16);
    v[1] = __uint_as_float(x & 0xFFFF0000u);
  } else {
    v[0] = widen(*p);
  }
}

// The streaming pass over the block's split of T, steps [t_begin, t_end)
// with t_begin = blockIdx.x * steps, and its tile of W = L blockDim.x lanes
// from blockIdx.y * W (W a multiple of 32 L): thread i serves the L lanes
// from L i, with that lane's arithmetic alone. With xp given: u[t, n] -=
// omega[t, n] sum_r X_p[r, t] dW[r, n] (each sum over r in order), stored
// in place; with xg given: part_m[split, r, n] = sum_t X_g[r, t] u_new[t,
// n] (u_new = u where xp is null); with want_sumom: part_s[split, n] =
// sum_t omega[t, n]. omega is Om: float (T, N) at "high", or uint16_t, the
// bf16 stream (T, ldo) with ldo = N8 a multiple of 8, at "default" and
// "sr"; each value is widened to fp32 before it is used, so both give the
// same u and sums on the same values. Copies past t_end or past the last
// lane are zero-filled, so they add nothing to M0 or sum_t omega.
template <int R, typename Om, bool kScatter, bool kGather>
__global__ void __launch_bounds__(kMaxLanes / lanes_per_thread<R>(),
                                  R <= 32 ? 2 : 1)
stream_pass_kernel(const float* __restrict__ xp,
                   const float* __restrict__ xg, const Om* __restrict__ om,
                   float* __restrict__ u, const float* __restrict__ dw,
                   float* __restrict__ part_m, float* __restrict__ part_s,
                   int T, int N, int ldo, int GB, int steps, int want_sumom) {
  using copy_reduce::cp_async16;
  using copy_reduce::cp_async4;
  constexpr int L = lanes_per_thread<R>();
  extern __shared__ __align__(16) float sm[];
  const int nt = blockDim.x, W = L * nt, tid = threadIdx.x;
  float* xps = sm;                          // [kStages][R][kCh]
  float* xgs = xps + kStages * R * kCh;     // [kStages][R][kCh]
  float* us = xgs + kStages * R * kCh;      // [kStages][kCh][W]
  Om* oms = reinterpret_cast<Om*>(us + kStages * kCh * W);
  const int lane0 = blockIdx.y * W, n0 = lane0 + L * tid;
  constexpr bool scatter = kScatter, gather = kGather;
  const bool need_om = scatter || want_sumom;
  const int t_begin = blockIdx.x * steps;
  const int t_end = min(T, t_begin + steps);
  const int nch = t_end > t_begin ? (t_end - t_begin + kCh - 1) / kCh : 0;

  // Copies of chunk c: a warp copies 32 consecutive elements of a row at a
  // time (lane j of the tile by thread j % nt), so the copies coalesce.
  auto load_chunk = [&](int c) {
    const int t0 = t_begin + c * kCh, b = c % kStages;
    for (int i = tid; i < GB * kCh; i += nt) {
      const int r = i / kCh, k = i % kCh, t = t0 + k;
      const bool ok = t < t_end;
      const size_t g = ok ? (size_t)r * T + t : 0;
      const int o = (b * R + r) * kCh + k;
      if constexpr (scatter) cp_async4(xps + o, xp + g, ok);
      if constexpr (gather) cp_async4(xgs + o, xg + g, ok);
    }
    if constexpr (sizeof(Om) == 2) {
      // kCh rows of W / 8 runs; runs past ldo and rows past t_end are
      // zero-filled (a run lies wholly inside a row: ldo and W are
      // multiples of 8).
      const int runs = W / 8;
      if (need_om)
        for (int i = tid; i < kCh * runs; i += nt) {
          const int k = i / runs, j = i % runs, t = t0 + k;
          const bool ok = t < t_end && lane0 + 8 * j < ldo;
          const Om* src = ok ? om + (size_t)t * ldo + lane0 + 8 * j : om;
          cp_async16(
              reinterpret_cast<float*>(oms + (b * kCh + k) * W + 8 * j),
              reinterpret_cast<const float*>(src), ok);
        }
    }
#pragma unroll
    for (int k = 0; k < kCh; ++k) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int j = tid + l * nt, n = lane0 + j, t = t0 + k;
        const bool ok = t < t_end && n < N;
        const int o = (b * kCh + k) * W + j;
        if constexpr (sizeof(Om) == 4)
          if (need_om)
            cp_async4(oms + o, om + (ok ? (size_t)t * ldo + n : 0), ok);
        cp_async4(us + o, u + (ok ? (size_t)t * N + n : 0), ok);
      }
    }
  };

  float d[L][R], m0[L][R], sum_om[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int n = n0 + l;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[l][r] = (scatter && r < GB && n < N) ? dw[(size_t)r * N + n] : 0.0f;
      m0[l][r] = 0.0f;
    }
    sum_om[l] = 0.0f;
  }

  // The design rows GB .. R - 1 of every stage stay zero, so that the
  // loops over r run all R rows with no test (their dW is zero too).
  for (int i = tid; i < kStages * (R - GB) * kCh; i += nt) {
    const int b = i / ((R - GB) * kCh), o = (b * R + GB) * kCh;
    xps[o + i % ((R - GB) * kCh)] = 0.0f;
    xgs[o + i % ((R - GB) * kCh)] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) load_chunk(c);
    copy_reduce::cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    copy_reduce::cp_async_wait<kStages - 2>();
    // Chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose buffer the next load refills.
    __syncthreads();
    if (c + kStages - 1 < nch) load_chunk(c + kStages - 1);
    copy_reduce::cp_async_commit();
    const int t0 = t_begin + c * kCh, b = c % kStages;
    const float* xpb = xps + b * R * kCh;
    const float* xgb = xgs + b * R * kCh;
#pragma unroll
    for (int k = 0; k < kCh; k += kGrp) {
      float w[kGrp][L], un[kGrp][L];
#pragma unroll
      for (int i = 0; i < kGrp; ++i) {
        const int o = (b * kCh + k + i) * W + L * tid;
        load_lanes<L>(oms + o, w[i]);
        load_lanes<L>(us + o, un[i]);
      }
#pragma unroll
      for (int i = 0; i < kGrp; i += 4)
#pragma unroll
        for (int l = 0; l < L; ++l)
          sum_om[l] += (w[i][l] + w[i + 1][l]) + (w[i + 2][l] + w[i + 3][l]);
      if constexpr (scatter) {
        // kGrp L independent sums, each over r in order.
        float sc[kGrp][L];
#pragma unroll
        for (int i = 0; i < kGrp; ++i)
#pragma unroll
          for (int l = 0; l < L; ++l) sc[i][l] = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          {
#pragma unroll
            for (int q = 0; q < kGrp; q += 4) {
              const float4 a =
                  *reinterpret_cast<const float4*>(xpb + r * kCh + k + q);
#pragma unroll
              for (int l = 0; l < L; ++l) {
                sc[q][l] = fmaf(a.x, d[l][r], sc[q][l]);
                sc[q + 1][l] = fmaf(a.y, d[l][r], sc[q + 1][l]);
                sc[q + 2][l] = fmaf(a.z, d[l][r], sc[q + 2][l]);
                sc[q + 3][l] = fmaf(a.w, d[l][r], sc[q + 3][l]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kGrp; ++i) {
          const int t = t0 + k + i;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            un[i][l] = un[i][l] - w[i][l] * sc[i][l];
            if (t < t_end && n0 + l < N)
              u[(size_t)t * N + n0 + l] = un[i][l];
          }
        }
      }
      if constexpr (gather) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          {
#pragma unroll
            for (int q = 0; q < kGrp; q += 4) {
              const float4 a =
                  *reinterpret_cast<const float4*>(xgb + r * kCh + k + q);
#pragma unroll
              for (int l = 0; l < L; ++l) {
                m0[l][r] = fmaf(a.x, un[q][l], m0[l][r]);
                m0[l][r] = fmaf(a.y, un[q + 1][l], m0[l][r]);
                m0[l][r] = fmaf(a.z, un[q + 2][l], m0[l][r]);
                m0[l][r] = fmaf(a.w, un[q + 3][l], m0[l][r]);
              }
            }
          }
        }
      }
    }
  }
  copy_reduce::cp_async_wait<0>();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int n = n0 + l;
    if (n >= N) continue;
    if constexpr (gather) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < GB) part_m[((size_t)blockIdx.x * GB + r) * N + n] = m0[l][r];
    }
    if (want_sumom) part_s[(size_t)blockIdx.x * N + n] = sum_om[l];
  }
}

// The 3xTF32 Gram of omega ("high") on wgmma (gram_wgmma.cuh::
// gram_tile_tf32): block (split, pair tile, lane tile) forms its tile's
// partial over its split of T, rows_per_split steps (a multiple of the
// 32-step stage) from split * rows_per_split, at part[split].
__global__ void __launch_bounds__(gram_wgmma::kThreads, 1)
group_pass_tf32_kernel(const float* __restrict__ xg,
                       const float* __restrict__ om,
                       const uint16_t* __restrict__ pq,
                       float* __restrict__ part, int T, int N, int GB,
                       int rows_per_split, int vec_x, int vec_o) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int npair = GB * (GB + 1) / 2, split = blockIdx.x;
  const int row0 = blockIdx.y * kK2Tf32NP;
  const int t_begin = split * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  gram_wgmma::gram_tile_tf32<kK2Tf32NP>(
      xg, T, GB, vec_x, om, N, vec_o, t_begin, t_end,
      blockIdx.z * gram_wgmma::kLT, pq + row0, min(kK2Tf32NP, npair - row0),
      part + ((size_t)split * npair + row0) * N, N, smem_raw);
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

template <int R, typename Om, bool kScatter, bool kGather>
cudaError_t launch_stream_mode(const float* xp, const float* xg, const Om* om,
                               float* u, const float* dw, float* part_m,
                               float* part_s, int T, int N, int ldo, int GB,
                               int n_split, int steps, int lanes,
                               int want_sumom, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      stream_pass_kernel<R, Om, kScatter, kGather>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      stream_smem_bytes<R, Om>(kMaxLanes));
  if (attr != cudaSuccess) return attr;
  if (lanes % (32 * lanes_per_thread<R>()) != 0)
    return cudaErrorInvalidValue;
  stream_pass_kernel<R, Om, kScatter, kGather>
      <<<dim3(n_split, (N + lanes - 1) / lanes),
         lanes / lanes_per_thread<R>(), stream_smem_bytes<R, Om>(lanes),
         s>>>(xp, xg, om, u, dw, part_m, part_s, T, N, ldo, GB, steps,
              want_sumom);
  return cudaGetLastError();
}

// The pass in its mode: the scatter (xp given) and the gather (xg given),
// or one of them.
template <int R, typename Om>
cudaError_t launch_stream_r(const float* xp, const float* xg, const Om* om,
                            float* u, const float* dw, float* part_m,
                            float* part_s, int T, int N, int ldo, int GB,
                            int n_split, int steps, int lanes,
                            int want_sumom, cudaStream_t s) {
  if (xp != nullptr && xg != nullptr)
    return launch_stream_mode<R, Om, true, true>(
        xp, xg, om, u, dw, part_m, part_s, T, N, ldo, GB, n_split, steps,
        lanes, want_sumom, s);
  if (xg != nullptr)
    return launch_stream_mode<R, Om, false, true>(
        xp, xg, om, u, dw, part_m, part_s, T, N, ldo, GB, n_split, steps,
        lanes, want_sumom, s);
  return launch_stream_mode<R, Om, true, false>(
      xp, xg, om, u, dw, part_m, part_s, T, N, ldo, GB, n_split, steps,
      lanes, want_sumom, s);
}

template <typename Om>
cudaError_t launch_stream_om(const float* xp, const float* xg, const Om* om,
                             float* u, const float* dw, float* part_m,
                             float* part_s, int T, int N, int ldo, int GB,
                             int n_split, int steps, int lanes,
                             int want_sumom, cudaStream_t s) {
  if (GB <= 16)
    return launch_stream_r<16>(xp, xg, om, u, dw, part_m, part_s, T, N, ldo,
                               GB, n_split, steps, lanes, want_sumom, s);
  if (GB <= 32)
    return launch_stream_r<32>(xp, xg, om, u, dw, part_m, part_s, T, N, ldo,
                               GB, n_split, steps, lanes, want_sumom, s);
  return launch_stream_r<64>(xp, xg, om, u, dw, part_m, part_s, T, N, ldo,
                             GB, n_split, steps, lanes, want_sumom, s);
}

// The streaming pass on omega in the caller's mode: om (fp32, row stride
// N) at "high" (gram 0), the bf16 stream om16 (row stride N8) otherwise.
cudaError_t launch_stream(const float* xp, const float* xg, const float* om,
                          const uint16_t* om16, float* u, const float* dw,
                          float* part_m, float* part_s, int T, int N, int N8,
                          int GB, int n_split, int steps, int lanes,
                          int want_sumom, int gram, cudaStream_t s) {
  if (gram == 0)
    return launch_stream_om(xp, xg, om, u, dw, part_m, part_s, T, N, N, GB,
                            n_split, steps, lanes, want_sumom, s);
  return launch_stream_om(xp, xg, om16, u, dw, part_m, part_s, T, N, N8, GB,
                          n_split, steps, lanes, want_sumom, s);
}

cudaError_t launch_tf32(const float* xg, const float* om, const uint16_t* pq,
                        float* part, int T, int N, int GB, int n_split,
                        int ntile, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_pass_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_wgmma::smem_bytes_tf32<kK2Tf32NP>(gram_wgmma::kMaxGB));
  if (attr != cudaSuccess) return attr;
  int rows = (T + n_split - 1) / n_split;
  rows = (rows + gram_wgmma::kKS3 - 1) / gram_wgmma::kKS3 * gram_wgmma::kKS3;
  const int vec_x = T % 4 == 0 && (size_t)xg % 16 == 0;
  const int vec_o = N % 4 == 0 && (size_t)om % 16 == 0;
  group_pass_tf32_kernel
      <<<dim3(n_split, ntile, (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT),
         gram_wgmma::kThreads, gram_wgmma::smem_bytes_tf32<kK2Tf32NP>(GB),
         s>>>(xg, om, pq, part, T, N, GB, rows, vec_x, vec_o);
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
// (bf16) at "default" and "sr"; pq, the pair table at the mode's tile.
cudaError_t launch_gram(const float* xg, const float* om,
                        const uint16_t* om16, const uint16_t* pq, float* part,
                        int T, int N, int N8, int GB, int n_split, int ntile,
                        int gram, unsigned long long seed,
                        unsigned long long offset, cudaStream_t s) {
  switch (gram) {
    case 0:
      return launch_tf32(xg, om, pq, part, T, N, GB, n_split, ntile, s);
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
// u: (T, N) updated in place; dw: (GB, N) or null. omega, read by the
// streaming pass and the Gram: at "high" (gram 0) om, (T, N) fp32; at
// "default" and "sr" (gram 1, 2) om16 alone (om is not read and may be
// null), omega rounded to bf16, (T, N8) with N8 >= N a multiple of 8, lanes
// past N zero and a 16-byte aligned start. With xg given: pq, ntile x NP
// pair-table entries p | q << 8 (0xFFFF past the last pair row), row-major
// over p <= q, NP the mode's tile (kK2Tf32NP at "high", kK2NP otherwise).
// The streaming pass: n_split_p splits of `steps` steps and tiles of
// `lanes` lanes (at most kMaxLanes, a multiple of 32 lanes_per_thread, 2
// at GB <= 32, 1 above). Scratch: part_g
// (n_split, GB(GB+1)/2, N), part_m (n_split_p, GB, N) and part_s
// (n_split_p, N). out: (GB + npair + 1, N) with rows [M0; packed Jgg;
// sum_t omega]; the last row is written only when want_sumom is set, and
// nothing is written to out when xg is null (the epilogue). gram: the
// Gram's mode (0 "high", 1 "default", 2 "sr"); seed and offset select the
// Philox words of "sr"'s rounding.
extern "C" int ss_group_pass_launch(const float* xg, const float* xp,
                                    const float* om, const void* om16,
                                    const void* pq, float* u,
                                    const float* dw, float* part_g,
                                    float* part_m, float* part_s, float* out,
                                    int T, int N, int N8, int GB, int n_split,
                                    int n_split_p, int steps, int lanes,
                                    int ntile, int want_sumom, int gram,
                                    unsigned long long seed,
                                    unsigned long long offset, void* stream) {
  const int npair = GB * (GB + 1) / 2;
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || n_split < 1 ||
      n_split_p < 1 || steps < 1 || (long long)n_split_p * steps < T ||
      (long long)(n_split_p - 1) * steps >= T || lanes < 32 ||
      lanes > kMaxLanes || lanes % 32 != 0 ||
      (N + lanes - 1) / lanes > 65535 || gram < 0 || gram > 2)
    return (int)cudaErrorInvalidValue;
  if (gram == 0 ? om == nullptr
                : om16 == nullptr || (size_t)om16 % 16 != 0 || N8 < N ||
                      N8 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int np = gram == 0 ? kK2Tf32NP : kK2NP;
  if (xg != nullptr &&
      (pq == nullptr || ntile < 1 || (ntile - 1) * np >= npair ||
       ntile * np < npair || n_split > 65535 ||
       (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* om16_ = (const uint16_t*)om16;
  if (dw == nullptr) xp = nullptr;
  want_sumom = want_sumom && xg != nullptr;
  if (xg == nullptr)      // the epilogue: the scatter alone
    return (int)(xp != nullptr
                     ? launch_stream(xp, nullptr, om, om16_, u, dw, nullptr,
                                     nullptr, T, N, N8, GB, n_split_p, steps,
                                     lanes, 0, gram, s)
                     : cudaSuccess);

  // Side stream: the streaming pass (memory-bound). Caller's stream: the
  // Gram of omega (tensor-bound), then the reductions, after both.
  Side* sd = nullptr;
  cudaError_t err = side_for_current_device(&sd);
  if (err != cudaSuccess ||
      (err = cudaEventRecord(sd->fork, s)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(sd->stream, sd->fork, 0)) != cudaSuccess ||
      (err = launch_stream(xp, xg, om, om16_, u, dw, part_m, part_s, T, N,
                           N8, GB, n_split_p, steps, lanes, want_sumom, gram,
                           sd->stream)) != cudaSuccess ||
      (err = cudaEventRecord(sd->join, sd->stream)) != cudaSuccess ||
      (err = launch_gram(xg, om, om16_, (const uint16_t*)pq, part_g, T, N,
                         N8, GB, n_split, ntile, gram, seed, offset, s)) !=
          cudaSuccess ||
      (err = cudaStreamWaitEvent(s, sd->join, 0)) != cudaSuccess)
    return (int)err;

  // out = [M0; Jgg; sum omega], each summed over its splits in order.
  using copy_reduce::reduce_splits;
  if ((err = reduce_splits(part_m, out, n_split_p, (long long)GB * N,
                           (long long)GB * N, s)) != cudaSuccess ||
      (err = reduce_splits(part_g, out + (size_t)GB * N, n_split,
                           (long long)npair * N, (long long)npair * N, s)) !=
          cudaSuccess)
    return (int)err;
  if (want_sumom)
    err = reduce_splits(part_s, out + (size_t)(GB + npair) * N, n_split_p, N,
                        N, s);
  return (int)err;
}
