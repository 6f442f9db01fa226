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
// pair-row tile, lane tile) and loops over all of T inside itself (the
// fp32 body: over one range of T, the ranges summed in order by a second
// pass); nothing is carried between blocks and no atomics are used, so
// results repeat from run to run. Only the triangle p <= q is formed: half
// the products of the TPU kernel's GB x GB block (820 pairs instead of 1600
// at GB = 40).
//
// Three bodies, chosen by the caller's precision:
//   - "high": group_gram_tf32_kernel, 3xTF32 on wgmma (gram_wgmma.cuh::
//     gram_tile_tf32, the tile K2's "high" Gram runs too): omega in fp32,
//     split into TF32 hi and lo in registers (wgmma's A), Z = X_p X_q formed
//     per stage into swizzled Z_hi and Z_lo tiles (B), three products per
//     8-step slice, a tile of kTf32NP = 120 pair rows x 128 lanes per block,
//     the fp32 accumulators folded every 64 steps into a second fp32 sum
//     (two-level, so no accumulator sums 2e4 terms). Its grid is ordered as
//     the "default" body's. Bound: 3 x 2 x 3.3e12 FLOP at config 5 over the
//     495 TFLOP/s TF32 peak (39.8 ms); mma.sync, whose TF32 products peak
//     near 310 TFLOP/s, bounds the same arithmetic near 100 TFLOP/s of fp32
//     work (an mma.sync tile loop took 136 ms there).
//   - "default": group_gram_wgmma_kernel, one bf16 pass on wgmma
//     (gram_wgmma.cuh): omega rounded once to a bf16 stream by the caller,
//     Z = X_p X_q rounded to bf16 as it is formed, a tile of 168 pair rows
//     x 128 lanes per block (_gram_kernel_fast rounds both operands inside
//     the kernel). Bound: 2 x 3.3e12 FLOP over the 989 TFLOP/s bf16 peak,
//     6.63 ms. Its grid runs the (pair tile, group) fastest and the lane
//     tile slowest, so the ~132 resident blocks share one lane tile's
//     omega slab in L2.
//   - "highest": group_gram_kernel, fp32 FMA on the CUDA cores (the JAX
//     package's "highest" takes its f32 XLA Gram, which sums per 512-step
//     chunk in a lax.scan). Bound: the fp32 FMA issue rate, 2 x 3.3e12
//     FLOP at config 5 over the 67 TFLOP/s fp32 peak (97.9 ms), 5.3e11 at
//     the flagship (7.9 ms). Each thread holds an 8 x 8 register
//     micro-tile fed by four float4 shared loads per 64 FMAs; a block's
//     tile is 80 pair rows x 200 lanes. A grid of less than one wave is
//     filled by splitting T into ranges summed by a second pass, the
//     split chosen per call by ops/gram_cuda.py::fp32_split_plan (the
//     flagship: 7 tiles per group, 3 splits, 525 blocks in 2 waves of
//     2 x 132; config 5: 11000 blocks, no split). Two blocks share an
//     SM. Per 16-step stage one barrier: omega and the design rows arrive
//     by cp.async one and two stages ahead, Z = X_p X_q of the next stage
//     is built into the free one of 2 Z buffers before the current
//     stage's products, and a warp whose rows all lie past the last pair
//     row skips the products. Every 512 steps the registers are folded by
//     Fast2Sum into a second fp32 sum in shared memory (so 2e4 terms are
//     never summed in one fp32 accumulator); without a split every output
//     is summed in the same order as a plain loop over t with those
//     folds. What sets its pace (PERF.md): the products loop itself (38
//     TFLOP/s with the Z build cut out at config 5), then the build (16%).
// The "high" and "default" grids are 8k-21k blocks at the 8-chain ensemble
// (Ng = 50, GB = 40, 4000 lanes, T = 2e4), so they do not split the time
// axis. The ragged T edge is masked in the loads (X and omega read as 0
// past T).

#include <cuda_runtime.h>

#include "copy_reduce.cuh"
#include "gram_wgmma.cuh"

namespace {

constexpr int kMaxGB = 64;
// Pair rows per tile of the 3xTF32 body: GB = 40's 820 pairs in 7 tiles
// (840 rows, 2.4% padding, as the "default" body's 5 tiles of 168).
constexpr int kTf32NP = 120;

// The fp32 body ("highest"): time steps per shared-memory stage, stages per
// fold (512 steps, the JAX Gram's chunk), the most shared memory a block
// may take so that two blocks share an SM, and its tile: 8 kRY pair rows x
// 8 kNX lanes on kRY kNX threads, one 8 x 8 register micro-tile each
// (80 x 200: the flagship's 200 lanes in one tile).
constexpr int kFS = 16;
constexpr int kFoldStages = 512 / kFS;
constexpr int kFMaxSmem = 115712;
constexpr int kRY = 10, kNX = 25;

// Shared memory of the fp32 body, in floats: 2 omega stages (kFS x 8 kNX),
// 2 Z stages (kFS x 8 kRY), a ring of 3 design stages stored step-major
// (kFS x (GB | 1): an odd row keeps the transposing copies and the Z build
// free of bank conflicts) and the second sums (64 per thread).
__host__ __device__ constexpr int fp32_smem_floats(int GB) {
  return 2 * kFS * 8 * (kNX + kRY) + 3 * kFS * (GB | 1) + 64 * kRY * kNX;
}

// acc[i][j] += sum over the stage's kFS steps of Z[8 ty + i, k] omega[k, n_j]
// with n_j = 4 tx + j (j < 4) or 4 kNX + 4 tx + j - 4: `a` and `b` point
// at the thread's first row and lane of the stage's Z (kFS x 8 kRY) and
// omega (kFS x 8 kNX) tiles. Four float4 loads feed 64 FMAs.
__device__ __forceinline__ void fp32_products(float (&acc)[8][8],
                                              const float* a,
                                              const float* b) {
#pragma unroll
  for (int k = 0; k < kFS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * 8 * kRY);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * 8 * kRY + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * 8 * kNX);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + k * 8 * kNX + 4 * kNX);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The fp32 body: block (pair tile, group, lane tile + n_lt x split) forms
// the tile's sums over the split's steps [split steps, (split + 1) steps)
// into dst + split * split_stride (the output itself when there is one
// split, else a partial for copy_reduce::reduce_splits). Per stage s, after one
// barrier: the copies of omega's stage s + 1 (16-byte cp.async where vec_o)
// and of the design rows' stage s + 2 (4-byte cp.async, transposed to
// step-major) are issued, Z of stage s + 1 is built from its landed design
// rows into the free Z buffer (each building thread keeps its pair row's
// (p, q) in registers), and stage s's products run; the barrier of stage
// s + 1 is the only one between them. The tile's shape is a constant, so
// every shared-memory address of the products and copies is an immediate
// offset. Two blocks share an SM (at most 128 registers a thread), so one
// block's build and copies overlap the other's products. Every kFoldStages
// stages the registers are folded by Fast2Sum into a second fp32 sum in
// shared memory (sum + acc = t + e exactly: sum takes t, e seeds the next
// chunk).
__global__ void __launch_bounds__(kRY * kNX, 2)
group_gram_kernel(const float* __restrict__ xt, const float* __restrict__ om,
                  float* __restrict__ dst, long long split_stride, int T,
                  int N, int GB, int n_lt, int steps, int vec_o) {
  constexpr int kTh = kRY * kNX, RT = 8 * kRY, NT = 8 * kNX;
  constexpr int kZk = kTh / RT;           // build: threads per pair row
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, xp = GB | 1;
  const int npair = GB * (GB + 1) / 2, row0 = blockIdx.x * RT;
  const int g = blockIdx.y, lane0 = (blockIdx.z % n_lt) * NT;
  const int split = blockIdx.z / n_lt;
  const int t_begin = split * steps, t_end = min(T, t_begin + steps);
  const int s_end = (t_end - t_begin + kFS - 1) / kFS;
  float* bs = smem;                       // [2][kFS][NT]
  float* as = bs + 2 * kFS * NT;          // [2][kFS][RT]
  float* xs = as + 2 * kFS * RT;          // [3][kFS][xp]
  float* sums = xs + 3 * kFS * xp;        // [64][kTh]
  const float* xg = xt + (size_t)g * GB * T;
#pragma unroll
  for (int e = 0; e < 64; ++e) sums[e * kTh + tid] = 0.0f;

  // The design rows of stage s into ring slot s % 3, omega's into s % 2.
  auto load_x = [&](int s) {
    const int t0 = t_begin + s * kFS;
    float* xd = xs + (s % 3) * kFS * xp;
    for (int i = tid; i < GB * kFS; i += kTh) {
      const int p = i / kFS, k = i % kFS, t = t0 + k;
      const bool ok = t < t_end;
      copy_reduce::cp_async4(xd + k * xp + p,
                             ok ? xg + (size_t)p * T + t : xg, ok);
    }
  };
  auto load_om = [&](int s) {
    const int t0 = t_begin + s * kFS;
    float* bd = bs + (s & 1) * kFS * NT;
    if (vec_o) {
#pragma unroll
      for (int c = tid; c < kFS * NT / 4; c += kTh) {
        const int k = c / (NT / 4), n = lane0 + 4 * (c % (NT / 4));
        const bool ok = t0 + k < t_end && n < N;
        copy_reduce::cp_async16(
            bd + 4 * c, ok ? om + (size_t)(t0 + k) * N + n : om, ok);
      }
    } else {
      for (int c = tid; c < kFS * NT; c += kTh) {
        const int k = c / NT, n = lane0 + c % NT;
        const bool ok = t0 + k < t_end && n < N;
        copy_reduce::cp_async4(bd + c,
                               ok ? om + (size_t)(t0 + k) * N + n : om, ok);
      }
    }
  };
  // Z of stage s into Z buffer s % 2: Z[k, r] = X[p_r, t] X[q_r, t], by the
  // first kZk RT threads: thread (zk, zr) forms row zr at steps zk + j kZk.
  const int zr = tid % RT, zk = tid / RT;
  int zp = -1, zq = 0;
  if (zk < kZk && row0 + zr < npair) {
    // Row pr of the packed triangle -> (p, q), row-major over p <= q.
    int rem = row0 + zr;
    zp = 0;
    while (rem >= GB - zp) rem -= GB - zp++;
    zq = zp + rem;
  }
  auto fp32_build_z = [&](int s) {
    if (zk >= kZk) return;
    const float* xsrc = xs + (s % 3) * kFS * xp;
    float* zd = as + (s & 1) * kFS * RT + zr;
#pragma unroll
    for (int j = 0; j < (kFS + kZk - 1) / kZk; ++j) {
      const int k = zk + j * kZk;
      if (k < kFS)
        zd[k * RT] = zp >= 0 ? xsrc[k * xp + zp] * xsrc[k * xp + zq] : 0.0f;
    }
  };

  const int tx = tid % kNX, ty = tid / kNX;
  // A warp whose first row lies past the last pair row skips the products
  // (every later thread of the warp has a later row).
  const bool busy = 8 * ((tid & ~31) / kNX) < npair - row0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_x(0);
  load_om(0);
  if (1 < s_end) load_x(1);
  copy_reduce::cp_async_commit();
  copy_reduce::cp_async_wait<0>();
  __syncthreads();
  fp32_build_z(0);
  for (int s = 0; s < s_end; ++s) {
    copy_reduce::cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < s_end) load_om(s + 1);
    if (s + 2 < s_end) load_x(s + 2);
    copy_reduce::cp_async_commit();
    if (s + 1 < s_end) fp32_build_z(s + 1);
    if (busy) {
      fp32_products(acc, as + (s & 1) * kFS * RT + 8 * ty,
                    bs + (s & 1) * kFS * NT + 4 * tx);
      if ((s + 1) % kFoldStages == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* sp = sums + (8 * i + j) * kTh + tid;
            const float a = *sp, b = acc[i][j], t = a + b;
            *sp = t;
            acc[i][j] = b - (t - a);
          }
      }
    }
  }

  float* o = dst + split * split_stride + (size_t)g * npair * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pr = row0 + 8 * ty + i;
    if (pr >= npair) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = lane0 + (j < 4 ? 4 * tx + j : 4 * kNX + 4 * tx + j - 4);
      if (n < N)
        o[(size_t)pr * N + n] = sums[(8 * i + j) * kTh + tid] + acc[i][j];
    }
  }
}

// Launch the fp32 body; see group_gram_fp32_launch.
cudaError_t launch_fp32(const float* xt, const float* om, float* dst,
                        long long split_stride, int T, int N, int GB, int Ng,
                        int n_split, int steps, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int npair = GB * (GB + 1) / 2;
  const int n_lt = (N + 8 * kNX - 1) / (8 * kNX);
  const int vec_o = N % 4 == 0 && (size_t)om % 16 == 0;
  group_gram_kernel<<<dim3((npair + 8 * kRY - 1) / (8 * kRY), Ng,
                           n_lt * n_split),
                      kRY * kNX, fp32_smem_floats(GB) * (int)sizeof(float),
                      s>>>(xt, om, dst, split_stride, T, N, GB, n_lt, steps,
                           vec_o);
  return cudaGetLastError();
}

// "high": 3xTF32 on wgmma; block (pair tile, group, lane tile), the grid
// ordered as the "default" body's.
__global__ void __launch_bounds__(gram_wgmma::kThreads, 1)
group_gram_tf32_kernel(const float* __restrict__ xt,
                       const float* __restrict__ om,
                       const uint16_t* __restrict__ pq,
                       float* __restrict__ out, int T, int N, int GB,
                       int vec_x, int vec_o) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int g = blockIdx.y, npair = GB * (GB + 1) / 2;
  const int row0 = blockIdx.x * kTf32NP;
  gram_wgmma::gram_tile_tf32<kTf32NP>(
      xt + (size_t)g * GB * T, T, GB, vec_x, om, N, vec_o, 0, T,
      blockIdx.z * gram_wgmma::kLT, pq + row0, min(kTf32NP, npair - row0),
      out + ((size_t)g * npair + row0) * N, N, smem_raw);
}

// "default": one bf16 pass on wgmma; block (pair tile, group, lane tile).
__global__ void __launch_bounds__(gram_wgmma::kThreads, 1)
group_gram_wgmma_kernel(const float* __restrict__ xt,
                        const uint16_t* __restrict__ om16,
                        const uint16_t* __restrict__ pq,
                        float* __restrict__ out, int T, int N, int N8, int GB,
                        int vec_x) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int g = blockIdx.y, npair = GB * (GB + 1) / 2;
  const int row0 = blockIdx.x * gram_wgmma::kNP;
  gram_wgmma::gram_tile(xt + (size_t)g * GB * T, T, GB, vec_x, om16, N8, N,
                        0, T, blockIdx.z * gram_wgmma::kLT, pq + row0,
                        min(gram_wgmma::kNP, npair - row0),
                        out + ((size_t)g * npair + row0) * N, N, smem_raw);
}

// One warpgroup, one k-loop of 4 wgmma k-steps through the same layouts,
// descriptors and accumulator map as gram_tile: d (64, kNP) = a^T b^T for a
// (64 steps, 64 lanes) and b (kNP rows, 64 steps), bf16, row-major.
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const uint16_t* __restrict__ a,
                   const uint16_t* __restrict__ b, float* __restrict__ d) {
  using namespace gram_wgmma;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* as = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* bs = as + kOmSlab;
  const int tid = threadIdx.x;
  for (int c = tid; c < 64 * 8; c += 128)
    *reinterpret_cast<uint4*>(as + sw128(c / 8, c % 8)) =
        *reinterpret_cast<const uint4*>(a + c * 8);
  for (int c = tid; c < kNP * 8; c += 128)
    *reinterpret_cast<uint4*>(bs + sw128(c / 8, c % 8)) =
        *reinterpret_cast<const uint4*>(b + c * 8);
  fence_proxy_async();
  __syncthreads();
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const uint32_t as_a = (uint32_t)__cvta_generic_to_shared(as);
  const uint32_t bs_a = (uint32_t)__cvta_generic_to_shared(bs);
  fence_acc(acc);
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < kKS / 16; ++kk)
    mma(acc, desc_a(as_a, kk), desc_b(bs_a, kk));
  mma_commit();
  mma_wait<0>();
  fence_acc(acc);
  const int w = tid / 32, l = tid % 32;
#pragma unroll
  for (int j = 0; j < kNP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * w + l / 4 + 8 * (e >> 1)) * kNP + 8 * j + 2 * (l % 4) +
        (e & 1)] = acc[4 * j + e];
}

// The 3xTF32 probe: one warpgroup, one stage (4 slices of 8 steps, 3
// products each) through the same A fragments, Z_hi / Z_lo layouts,
// descriptors and accumulator map as gram_tile_tf32: d (64, kTf32NP) = the
// 3xTF32 product of a^T (a: 32 steps x 64 lanes, fp32, row-major, read as
// an omega stage) and b^T (b: kTf32NP rows x 32 steps, fp32, split into
// the two tiles as the Z build splits Z).
__global__ void __launch_bounds__(128)
wgmma_tf32_probe_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ d) {
  using namespace gram_wgmma;
  constexpr int kZB = kTf32NP * 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* zs = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  float* os = reinterpret_cast<float*>(zs + 2 * kZB);
  const int tid = threadIdx.x;
  for (int e = tid; e < kKS3 * 64; e += 128)
    os[(e / 64) * kOS3 + e % 64] = a[e];
  for (int c = tid; c < kTf32NP * 8; c += 128) {
    const float4 v = *reinterpret_cast<const float4*>(b + c * 4);
    uint4 h, l;
    copy_reduce::split(v.x, h.x, l.x);
    copy_reduce::split(v.y, h.y, l.y);
    copy_reduce::split(v.z, h.z, l.z);
    copy_reduce::split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(zs + sw128(c / 8, c % 8)) = h;
    *reinterpret_cast<uint4*>(zs + kZB + sw128(c / 8, c % 8)) = l;
  }
  fence_proxy_async();
  __syncthreads();
  const int w = tid / 32, l = tid % 32;
  uint32_t ah[kKS3 / 8][4], al[kKS3 / 8][4];
  load_a_tf32(os + (l % 4) * kOS3 + 16 * w + l / 4, ah, al);
  float acc[kTf32NP / 2];
#pragma unroll
  for (int i = 0; i < kTf32NP / 2; ++i) acc[i] = 0.0f;
  const uint32_t zs_a = (uint32_t)__cvta_generic_to_shared(zs);
  fence_acc(acc);
  fence_regs(ah);
  fence_regs(al);
  mma_fence();
  products_tf32(acc, ah, al, zs_a, zs_a + kZB);
  mma_commit();
  mma_wait<0>();
  fence_acc(acc);
  fence_regs(ah);
  fence_regs(al);
#pragma unroll
  for (int j = 0; j < kTf32NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[(16 * w + l / 4 + 8 * (e >> 1)) * kTf32NP + 8 * j + 2 * (l % 4) +
        (e & 1)] = acc[4 * j + e];
}

}  // namespace

// xt: (>= Ng GB, T) design rows, group g in rows [g GB, (g + 1) GB);
// om: (T, N); pq: ntile x kTf32NP pair-table entries p | q << 8 (0xFFFF
// past the last pair row), row-major over p <= q; out: (Ng, GB(GB+1)/2,
// N), every element written. The 3xTF32 body ("high"); the fp32 body
// ("highest") is group_gram_fp32_launch, the bf16 body ("default")
// group_gram_bf16_launch.
extern "C" int group_gram_launch(const float* xt, const float* om,
                                 const void* pq, float* out, int T, int N,
                                 int GB, int Ng, int ntile, void* stream) {
  const int npair = GB * (GB + 1) / 2;
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || Ng < 1 || Ng > 65535 ||
      pq == nullptr || ntile < 1 || (ntile - 1) * kTf32NP >= npair ||
      ntile * kTf32NP < npair ||
      (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_gram_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_wgmma::smem_bytes_tf32<kTf32NP>(kMaxGB));
  if (attr != cudaSuccess) return (int)attr;
  const int vec_x = T % 4 == 0 && (size_t)xt % 16 == 0;
  const int vec_o = N % 4 == 0 && (size_t)om % 16 == 0;
  dim3 grid(ntile, Ng, (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT);
  group_gram_tf32_kernel<<<grid, gram_wgmma::kThreads,
                           gram_wgmma::smem_bytes_tf32<kTf32NP>(GB),
                           (cudaStream_t)stream>>>(
      xt, om, (const uint16_t*)pq, out, T, N, GB, vec_x, vec_o);
  return (int)cudaGetLastError();
}

// The "highest" body. xt, om and out as above; T split into n_split ranges
// of `steps` steps (a multiple of 512, so folds fall on the same steps as
// without a split), summed by a second pass from part ((n_split, Ng,
// GB(GB+1)/2, N) floats) when n_split > 1 (ops/gram_cuda.py::
// fp32_split_plan chooses).
extern "C" int group_gram_fp32_launch(const float* xt, const float* om,
                                      float* out, float* part, int T, int N,
                                      int GB, int Ng, int n_split, int steps,
                                      void* stream) {
  const int npair = GB * (GB + 1) / 2;
  const int n_lt = (N + 8 * kNX - 1) / (8 * kNX);
  if (GB < 1 || GB > kMaxGB || T < 1 || N < 1 || Ng < 1 || Ng > 65535 ||
      n_split < 1 || steps < 1 || steps % (kFS * kFoldStages) != 0 ||
      (long long)(n_split - 1) * steps >= T ||
      (long long)n_split * steps < T || (n_split > 1 && part == nullptr) ||
      (long long)n_lt * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long count = (long long)Ng * npair * N;
  float* dst = n_split > 1 ? part : out;
  cudaError_t err =
      launch_fp32(xt, om, dst, count, T, N, GB, Ng, n_split, steps, s);
  if (err == cudaSuccess && n_split > 1)
    err = copy_reduce::reduce_splits(part, out, n_split, count, count, s);
  return (int)err;
}

// The "default" body. xt as above; om16: (T, N8) omega rounded to bf16,
// N8 = N rounded up to a multiple of 8, lanes past N zero; pq: ntile x kNP
// pair-table entries p | q << 8 (0xFFFF past the last pair row), row-major
// over p <= q; out: (Ng, GB(GB+1)/2, N), every element written.
extern "C" int group_gram_bf16_launch(const float* xt, const void* om16,
                                      const void* pq, float* out, int T,
                                      int N, int N8, int GB, int Ng,
                                      int ntile, void* stream) {
  using gram_wgmma::kNP;
  const int npair = GB * (GB + 1) / 2;
  if (GB < 1 || GB > gram_wgmma::kMaxGB || T < 1 || N < 1 || N8 < N ||
      N8 % 8 != 0 || (size_t)om16 % 16 != 0 || Ng < 1 || Ng > 65535 ||
      ntile < 1 || (ntile - 1) * kNP >= npair || ntile * kNP < npair ||
      (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT > 65535)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_gram_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gram_wgmma::smem_bytes(gram_wgmma::kMaxGB));
  if (attr != cudaSuccess) return (int)attr;
  const int vec_x = T % 4 == 0 && (size_t)xt % 16 == 0;
  dim3 grid(ntile, Ng, (N + gram_wgmma::kLT - 1) / gram_wgmma::kLT);
  group_gram_wgmma_kernel<<<grid, gram_wgmma::kThreads,
                            gram_wgmma::smem_bytes(GB),
                            (cudaStream_t)stream>>>(
      xt, (const uint16_t*)om16, (const uint16_t*)pq, out, T, N, N8, GB,
      vec_x);
  return (int)cudaGetLastError();
}

// The wgmma layout probe: d (64, 168) fp32 = a^T b^T, a (64, 64) and b
// (168, 64) bf16, row-major.
extern "C" int wgmma_probe_launch(const void* a, const void* b, float* d,
                                  void* stream) {
  wgmma_probe_kernel<<<1, 128,
                       1024 + gram_wgmma::kOmSlab + gram_wgmma::kZBuf,
                       (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)b, d);
  return (int)cudaGetLastError();
}

// The 3xTF32 probe: d (64, 120) fp32, the 3xTF32 product of a^T and b^T,
// a (32, 64) and b (120, 32) fp32, row-major.
extern "C" int wgmma_tf32_probe_launch(const float* a, const float* b,
                                       float* d, void* stream) {
  constexpr int smem =
      1024 + 2 * kTf32NP * 128 + gram_wgmma::kKS3 * gram_wgmma::kOS3 * 4;
  wgmma_tf32_probe_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(a, b, d);
  return (int)cudaGetLastError();
}
