// K5: Chinese-restaurant-table counts l = sum_{k < m} Bern(r / (r + k)),
// m = min(y, max_y), per element of y (T, N) with r read by column, and the
// same counts summed per column.
//
// Replaces the TPU kernel pyglm_tpu/ops/pg_pallas.py::_crt_kernel (launched
// by crt_sample_pallas). Mosaic had no per-lane loops, so the TPU kernel ran
// every element to max_y under masks. Here the work follows the data's
// sum of m, not the largest count of a warp.
//
// The draws. Trial 0 has p = 1 and seats a table whenever m > 0 (and r >
// 0); it draws nothing. Trial k >= 1 seats one iff u (r + k) < r, in fp32
// with round-to-nearest and no division, u = (word >> 8) 2^-24 from word
// (k - 1) & 3 of the Philox4x32-10 draw with counter ((k - 1) / 4, element,
// offset lo, offset hi) and key seed: all four words of a draw are used,
// and a draw depends only on (seed, offset, element, trial), not on which
// thread makes it. The law differs from u < r / (r + k) by at most one
// 2^-24 step. ops/crt_cuda.py::crt_sample_twin repeats every draw in numpy.
//
// The layout. A warp takes 128 consecutive elements a step, 4 per lane
// (16-byte loads and stores where the pointer allows, a guarded tail). An
// element with m >= 2 has units: groups of up to four trials, one Philox
// draw each, ceil((m - 1) / 4) of them. A warp prefix sum of the units lays
// them out over the 32 lanes, each lane finds its unit's element by a
// binary search of the prefix in shared memory, and the units' counts meet
// in per-element shared-memory adds. A warp runs ceil(units / 32) rounds:
// its cost follows the units, and elements with m <= 1 draw nothing. The
// column of a lane's elements is found once per kernel and advanced each
// step (32-bit arithmetic; numel < 2^31).
//
// The sums form reads y once and writes no (T, N) array: for N <= 49152 each
// block sums its counts per column in shared memory and adds them to the
// (N,) output with one 64-bit integer atomicAdd per nonzero column; for
// wider y (stacked chains' lanes) each nonzero count is added straight to
// the output. Integer sums do not depend on order, so both forms are
// bit-repeatable.
//
// Bound on the H100: memory, 8 bytes an element (4 for the sums form) at
// 3.35 TB/s: 0.048 ms (0.024) at (100000, 200). What sets the pace is the
// unit rounds, not the bytes or Philox (PERF.md, time_k3_k4.py --only k5
// --cut): at the NB flagship's counts (0.14 units an element) the kernel
// without its rounds runs near 1.3x its bound, and the rest goes mostly
// to Philox and to the dependent shared-memory loads of a unit's binary
// search (Philox half of the rounds at a mean count of 4.5).
// Writing and reading a warp's shared tables 16 bytes a lane (no bank
// conflicts) took 14% off; a register cap for 8 blocks an SM then gains
// 1-5% (not taken). Loads of the next two chunks held in flight, an owner
// list written per round in place of the search, 8 elements a lane, and
// the sums form's column adds made by consecutive lanes on consecutive
// columns were each tried and were no faster at both count sets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;              // elements per warp and step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSumsN = 49152;         // columns of the sums form's table

// Philox4x32-10 (Salmon et al. 2011): four 32-bit words from counter c and
// key k (the generator of ops/ss_cuda.py::philox4x32).
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Trial k >= 1 seats a table iff u (r + k) < r, u = (w >> 8) 2^-24.
__device__ __forceinline__ int seat(uint32_t w, float r, int k) {
  const float u = __uint2float_rn(w >> 8) * 5.9604645e-08f;
  return __fmul_rn(u, __fadd_rn(r, (float)k)) < r;
}

// m = min(y, max_y), 0 for y < 1 or NaN; y holds whole counts.
__device__ __forceinline__ int trials(float v, int max_y) {
  return v >= 1.0f ? (int)fminf(v, (float)max_y) : 0;
}
__device__ __forceinline__ int trials(int v, int max_y) {
  return min(max(v, 0), max_y);
}

template <typename Y> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int> { using T = int4; };

// m of the elements e0 .. e0 + 3 (0 past n).
template <typename Y>
__device__ __forceinline__ void load4(const Y* __restrict__ y, uint32_t e0,
                                      uint32_t n, bool vec, int max_y,
                                      int m[4]) {
  if (vec && e0 + 3 < n) {
    using V = typename Vec4<Y>::T;
    const V v = __ldg(reinterpret_cast<const V*>(y + e0));
    m[0] = trials(v.x, max_y);
    m[1] = trials(v.y, max_y);
    m[2] = trials(v.z, max_y);
    m[3] = trials(v.w, max_y);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m[j] = e0 + j < n ? trials(__ldg(y + e0 + j), max_y) : 0;
  }
}

template <typename Y, bool kSums>
__global__ void __launch_bounds__(kThreads)
crt_kernel(const Y* __restrict__ y, const float* __restrict__ r,
           int* __restrict__ out, unsigned long long* __restrict__ sums,
           uint32_t n, uint32_t N, int max_y, uint2 key, uint32_t off_lo,
           uint32_t off_hi, bool vec) {
  __shared__ __align__(16) int s_pref[kWarps][kChunk];  // prefix of units
  __shared__ __align__(16) int s_m[kWarps][kChunk];
  __shared__ __align__(16) float s_r[kWarps][kChunk];
  __shared__ __align__(16) int s_cnt[kWarps][kChunk];   // units' seats
  extern __shared__ uint32_t s_col[];      // table: the block's column sums
  const bool table = kSums && N <= (uint32_t)kMaxSumsN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (table) {
    for (uint32_t i = threadIdx.x; i < N; i += kThreads) s_col[i] = 0;
    __syncthreads();
  }
  *reinterpret_cast<int4*>(&s_cnt[warp][4 * lane]) = make_int4(0, 0, 0, 0);
  const uint32_t n_chunks = (n + kChunk - 1) / kChunk;
  const uint32_t step = gridDim.x * kWarps;
  uint32_t c = blockIdx.x * kWarps + warp;
  uint32_t col0 = (c * kChunk + 4 * lane) % N;
  const uint32_t dcol = (uint32_t)((unsigned long long)step * kChunk % N);
  for (; c < n_chunks; c += step) {
    const uint32_t base = c * kChunk, e0 = base + 4 * lane;
    int m[4], l[4], units[4];
    uint32_t col[4];
    float rj[4];
    load4(y, e0, n, vec, max_y, m);
    col[0] = col0;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      col[j] = col[j - 1] + 1;
      while (col[j] >= N) col[j] -= N;      // once at most for N >= 4
    }
    int tot = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rj[j] = m[j] > 0 ? __ldg(r + col[j]) : 0.0f;
      l[j] = m[j] > 0 && rj[j] > 0.0f;      // trial 0: p = 1
      units[j] = (m[j] + 2) >> 2;           // ceil((m - 1) / 4) for m >= 1
      tot += units[j];
    }
    int incl = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (total > 0) {                        // warp-uniform
      const int p0 = incl - tot + units[0], p1 = p0 + units[1];
      const int p2 = p1 + units[2];
      *reinterpret_cast<int4*>(&s_pref[warp][4 * lane]) =
          make_int4(p0, p1, p2, p2 + units[3]);
      *reinterpret_cast<int4*>(&s_m[warp][4 * lane]) =
          make_int4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(&s_r[warp][4 * lane]) =
          make_float4(rj[0], rj[1], rj[2], rj[3]);
      __syncwarp();
      for (int s = lane; s < total; s += 32) {
        int le = 0;                          // first element with pref > s
#pragma unroll
        for (int b = kChunk / 2; b > 0; b >>= 1)
          if (s_pref[warp][le + b - 1] <= s) le += b;
        const int q = s - (le ? s_pref[warp][le - 1] : 0);
        const int mm = s_m[warp][le];
        const float rr = s_r[warp][le];
        const uint4 w = philox(make_uint4(q, base + le, off_lo, off_hi), key);
        const int k = 1 + 4 * q;
        int seats = seat(w.x, rr, k);
        if (k + 1 < mm) seats += seat(w.y, rr, k + 1);
        if (k + 2 < mm) seats += seat(w.z, rr, k + 2);
        if (k + 3 < mm) seats += seat(w.w, rr, k + 3);
        if (seats) atomicAdd(&s_cnt[warp][le], seats);
      }
      __syncwarp();
      int4* cnt = reinterpret_cast<int4*>(&s_cnt[warp][4 * lane]);
      const int4 sc = *cnt;
      *cnt = make_int4(0, 0, 0, 0);
      l[0] += sc.x;
      l[1] += sc.y;
      l[2] += sc.z;
      l[3] += sc.w;
      __syncwarp();
    }
    if (table) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l[j]) atomicAdd(&s_col[col[j]], (uint32_t)l[j]);
    } else if (kSums) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l[j]) atomicAdd(sums + col[j], (unsigned long long)l[j]);
    } else if (vec && e0 + 3 < n) {
      *reinterpret_cast<int4*>(out + e0) = make_int4(l[0], l[1], l[2], l[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j < n) out[e0 + j] = l[j];
    }
    col0 += dcol;
    if (col0 >= N) col0 -= N;
  }
  if (table) {
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < N; i += kThreads)
      if (s_col[i]) atomicAdd(sums + i, (unsigned long long)s_col[i]);
  }
}

// Blocks: as many as stay resident on the card at once (one wave, each
// block walking the chunks), at least enough that no block's column sum in
// a shared table can pass 2^32 - 1, at most one per 8 chunks.
template <typename Y, bool kSums>
int launch(const Y* y, const float* r, void* out, uint32_t n, uint32_t N,
           int max_y, unsigned long long seed, unsigned long long offset,
           bool vec, cudaStream_t s) {
  auto kern = crt_kernel<Y, kSums>;
  const bool table = kSums && N <= (uint32_t)kMaxSumsN;
  const size_t smem = table ? (size_t)N * sizeof(uint32_t) : 0;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return (int)err;
  const unsigned long long chunks = (n + kChunk - 1) / kChunk;
  const unsigned long long most = (chunks + kWarps - 1) / kWarps;
  unsigned long long blocks = (unsigned long long)sms * (per_sm > 0 ? per_sm : 1);
  if (table && max_y > 0) {
    // a block's step covers kWarps * kChunk consecutive elements, which hold
    // at most ceil(1024 / N) of a column, each at most max_y (<= 2^20)
    const unsigned long long per_step =
        ((kWarps * kChunk + N - 1) / N) * (unsigned long long)max_y;
    const unsigned long long steps = 0xffffffffull / per_step;
    const unsigned long long need = (most + steps - 1) / steps;
    if (blocks < need) blocks = need;
  }
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  crt_kernel<Y, kSums><<<(unsigned)blocks, kThreads, smem, s>>>(
      y, r, kSums ? nullptr : (int*)out,
      kSums ? (unsigned long long*)out : nullptr, n, N, max_y, key,
      (uint32_t)offset, (uint32_t)(offset >> 32), vec);
  return (int)cudaGetLastError();
}

}  // namespace

// out: int32 (n,) counts, or (sums) a zeroed int64 (N,) of column sums.
extern "C" int crt_sample_launch(const void* y, int y_is_float,
                                 const float* r, void* out, int sums,
                                 long long n, int N, int max_y,
                                 unsigned long long seed,
                                 unsigned long long offset, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || N < 1 || max_y < 0 || max_y > (1 << 20))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = ((uintptr_t)y % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const uint32_t un = (uint32_t)n, uN = (uint32_t)N;
  if (y_is_float)
    return sums ? launch<float, true>((const float*)y, r, out, un, uN, max_y,
                                      seed, offset, vec, s)
                : launch<float, false>((const float*)y, r, out, un, uN,
                                       max_y, seed, offset, vec, s);
  return sums ? launch<int, true>((const int*)y, r, out, un, uN, max_y, seed,
                                  offset, vec, s)
              : launch<int, false>((const int*)y, r, out, un, uN, max_y,
                                   seed, offset, vec, s);
}
