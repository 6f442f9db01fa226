// The warpgroup (wgmma) tile machinery of the Grams on Hopper (sm_90a):
// one thread block computes, for one tile of packed pair rows and 128
// postsyn lanes,
//
//   C[pr, n] = sum_{t_begin <= t < t_end} bf16(X[p, t] X[q, t]) bf16(om[t, n])
//
// over the pair rows pr -> (p, q) of a group's GB design rows: the product
// formed in fp32 from the fp32 design and rounded to nearest even (or, with
// kSr, stochastically by Philox words, as ss_pallas.py::_sr16), omega read
// as bf16 (the caller rounds it once), the sums in fp32. K6's "default"
// body (group_gram.cu) runs it over all of T, replacing
// pyglm_tpu/ops/gram_pallas.py::_gram_kernel_fast (pallas_call at :143),
// whose MXU takes bf16 omega and a bf16 Z the same way; K2's "default" and
// "sr" Grams (ss_group_pass.cu) run it over splits of T, replacing the
// gram == "bf16" and "sr" bodies of ss_pallas.py::_make_kernel (:343-347).
// The same tile in a third mode, 3xTF32 on fp32 operands (gram_tile_tf32,
// at the end of this file), is K6's and K2's "high" Gram.
//
// Bound on the H100 at config 5 (Ng = 50 groups of GB = 40, 4000 lanes,
// T = 2e4): 3.28e12 FMA, 6.63 ms at the 989 TFLOP/s bf16 peak; the bytes
// (design and omega in, the packed Gram out) take ~1 ms at 3.35 TB/s.
//
// What the design does about reuse and traffic:
//   - Orientation: the lanes are wgmma's M (64 per warpgroup, two
//     warpgroups per block) and the pair rows its N, so one omega tile
//     feeds a whole pair tile of kNP = 168 rows: GB = 40's 820 pairs are 5
//     tiles (840 rows, 2.4% padding; 13 tiles of 64 in the mma.sync loop).
//     A (omega) is read lane-major (wgmma's transpose bit), B (Z) K-major.
//     kNP = 168 keeps the two fp32 sums (2 x 84 registers per thread) and
//     the rest at the 255-register limit (252 bytes spilled) at one block
//     per SM; a first body with 208 rows (4 tiles) spilled 692 bytes.
//   - omega streams as bf16 (half the bytes of the fp32 stream), by
//     cp.async 16-byte copies into the 128-byte-swizzled layout the wgmma
//     descriptor names, in a ring of kStages stages of kKS = 64 steps; the
//     design rows stream as fp32 (Z needs the fp32 products), 16-byte
//     copies where rows are 16-byte aligned, 4-byte copies otherwise; both
//     zero-filled past T and past the last lane.
//   - Z = X_p X_q is formed by the whole block straight into the swizzled
//     K-major B tile, double-buffered, while the tensor cores run this
//     stage's products (wgmma is asynchronous). Each thread forms one
//     16-byte chunk (8 steps) of a run of consecutive pair rows, which
//     mostly share p: X_p's chunk stays in registers and only X_q is read
//     from shared memory per row (the build, not the tensor cores, set the
//     pace of a first body that read both per chunk). The barrier of a
//     stage and the next copies are issued while the products run; the
//     products are waited for only before the fold.
//   - The caller orders its grid so that the blocks resident together
//     share one lane tile's omega slab (5 MB at T = 2e4, which L2 holds):
//     omega leaves HBM about once, and L2 sends each SM ~0.3 of the bytes
//     per product of the 64-row mma.sync tile.
//   - What sets the pace (H100, config 5, 35.4 ms; time_group_gram.py
//     --cut): the copies and barriers alone take 14.2 ms (~26 KB per stage
//     from L2 into each SM, ~4.7 TB/s in all), the products raise that to
//     18.3 ms, and the Z build, formed anew for each of the 32 lane tiles,
//     to 35.4 ms, with or without the products. A cluster of two pair
//     tiles sharing each stage's copies (TMA multicast) halved the L2 bytes
//     and ran 47.0 ms, so the copies stay on cp.async.
//   - K2 runs the tile at NP = 176 pair rows (GB = 32's 528 pairs in 3
//     tiles), over splits of T that fill one wave of 132 blocks. At the
//     flagship group (H100, time_group_pass.py) its Gram takes ~0.19 ms
//     ("default") and ~0.26 ("sr", the Philox draws in the Z build), 0.11
//     without the Z build: the build sets the pace here too. 168-row tiles
//     (4 tiles, 128 blocks) ran 0.22 / 0.32 ms, 136-row tiles (4 tiles,
//     32 B spilled against ~340) 0.19 / 0.27.
//   - The tensor cores truncate as they accumulate, so the fp32
//     accumulators are folded every kFold stages (256 steps) into a second
//     fp32 sum by Fast2Sum (as the mma.sync tile loop before this
//     header did; see gram_tile_tf32 below): 3.0e-7 from a float64 Gram
//     at config 5 (1.8e-7 folded every 128 steps; the plain version
//     5.7e-7). No atomics: a tile's sums run in one order (K2's splits of
//     T are summed in split order by its reduction), so results repeat bit
//     for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy_reduce.cuh"

namespace gram_wgmma {

constexpr int kNP = 168;        // pair rows per tile of K6's body: wgmma's N
constexpr int kLT = 128;        // lanes per tile: 2 warpgroups x wgmma's M
constexpr int kKS = 64;         // time steps per stage: one 128-byte line
constexpr int kStages = 5;      // ring depth: stages s + 1 .. s + 4 in flight
constexpr int kThreads = 256;
constexpr int kFold = 4;        // stages per fold (256 steps)
constexpr int kMaxGB = 64;
constexpr int kAcc = kNP / 2;   // fp32 accumulators per thread (64 x kNP / 128)

// Shared memory, in bytes; the omega and Z tiles sit on 1024-byte
// boundaries (the period of the 128-byte swizzle).
constexpr int kOmSlab = kKS * 128;            // 64 lanes x 64 steps, bf16
constexpr int kOmStage = 2 * kOmSlab;         // 128 lanes
constexpr int kZBuf = kNP * 128;              // kNP rows x 64 steps, bf16
__host__ __device__ constexpr int x_stage_bytes(int GB) {
  return GB * kKS * 4;
}
// ... of a tile of NP pair rows.
template <int NP = kNP>
__host__ __device__ constexpr int smem_bytes(int GB) {
  return 1024 + kStages * kOmStage + 2 * NP * 128 +
         kStages * x_stage_bytes(GB);
}

// Byte offset of 16-byte chunk c (0..7) of 128-byte line r in a tile laid
// out with the 128-byte swizzle: chunk c of line r sits at c ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A: a 64-lane slab of omega, lane-major (MN-major): line k holds the 64
// lanes of step k; the 8-line groups along K lie 1024 bytes apart (SBO),
// and the 64-lane block is the whole of M (LBO names the next one).
// k-step kk (16 steps) starts 16 lines further on.
__device__ __forceinline__ uint64_t desc_a(uint32_t slab, int kk) {
  return desc(slab + kk * 16 * 128, kOmSlab, 1024);
}

// B: Z, K-major: line n holds the 64 steps of pair row n; the 8-row
// groups along N lie 1024 bytes apart (SBO; LBO unused with a swizzle).
// k-step kk starts 32 bytes into each line.
__device__ __forceinline__ uint64_t desc_b(uint32_t zbuf, int kk) {
  return desc(zbuf + kk * 32, 16, 1024);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Thread writes to shared memory (the Z build, cp.async) become visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int A>
__device__ __forceinline__ void fence_acc(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GW_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GW_R16(i) GW_R4(i), GW_R4(i + 4), GW_R4(i + 8), GW_R4(i + 12)

// d += A^T B for one k-step: A a 16 x 64 lane-major omega tile (transposed
// by the hardware), B a 16-step x NP-row K-major Z tile; d is the 64 x NP
// fp32 accumulator of the warpgroup (A = NP / 2 per thread). Thread (warp
// w, lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4)
// (+ 1): d[4 j + e] at row + 8 (e / 2), column + (e % 2).
template <int A>
__device__ __forceinline__ void mma(float (&d)[A], uint64_t da,
                                    uint64_t db) {
  static_assert(A == 84 || A == 88, "NP = 168 (K6) or 176 (K2)");
  if constexpr (A == 88) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87"
        "}, %88, %89, p, 1, 1, 1, 0;\n}\n"
        : GW_R16(0), GW_R16(16), GW_R16(32), GW_R16(48), GW_R16(64),
          GW_R4(80), GW_R4(84)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %86, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
        "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
        "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
        "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
        "%78, %79, %80, %81, %82, %83}, "
        "%84, %85, p, 1, 1, 1, 0;\n}\n"
        : GW_R16(0), GW_R16(16), GW_R16(32), GW_R16(48), GW_R16(64),
          GW_R4(80)
        : "l"(da), "l"(db), "r"(1));
  }
}

// The 3xTF32 mode's product: d += A^T B for one 8-step k-slice, A a 64-lane
// x 8-step TF32 tile of omega held in registers (a[4] per thread: thread
// (warp w, lane l) holds lanes 16 w + l / 4 (+ 8 in a[1], a[3]) at steps
// l % 4 (+ 4 in a[2], a[3]), as an mma.sync m16n8k8 A fragment), B an
// 8-step x NP-row K-major TF32 tile of Z in shared memory; d as in mma().
// TF32 operands read from shared memory must be K-major (the transpose
// bits exist only for 16-bit types), so omega, lane-major in its stage,
// comes from registers.
template <int A>
__device__ __forceinline__ void mma_tf32(float (&d)[A],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(A == 60 || A == 68, "NP = 120 (K6) or 136 (K2)");
  if constexpr (A == 68) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : GW_R16(0), GW_R16(16), GW_R16(32), GW_R16(48), GW_R4(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
        "{%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
        : GW_R16(0), GW_R16(16), GW_R16(32), GW_R4(48), GW_R4(52),
          GW_R4(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef GW_R16
#undef GW_R4

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// lo and hi rounded to bf16 (to nearest even), packed: lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Philox4x32-10 (Salmon et al. 2011, the generator of curand's Philox
// states): four 32-bit words from counter c and key k.
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// lo and hi rounded stochastically to bf16 by the low and the high 16 bits
// of r, packed: each x becomes bits (bits(x) + r16) & 0xFFFF0000
// (ss_pallas.py::_sr16), one of its two bf16 neighbours (x itself when x is
// a bf16 value), the upper one with probability proportional to x's
// distance from the lower; E over uniform words is x.
__device__ __forceinline__ uint32_t sr_bf16x2(float lo, float hi,
                                              uint32_t r) {
  return __byte_perm(__float_as_uint(lo) + (r & 0xFFFFu),
                     __float_as_uint(hi) + (r >> 16), 0x7632);
}

// The 8 floats at row + 0 .. 7 (16-byte aligned) as (lo, hi). h0 = 4 loads
// the upper half first: the 8 threads of a quarter warp reading chunks c =
// 0..7 of one design row (h0 = 4 for c >= 4) then hit distinct banks.
__device__ __forceinline__ void load8(const float* row, int h0, float4& lo,
                                      float4& hi) {
  const float4 u = *reinterpret_cast<const float4*>(row + h0);
  const float4 w = *reinterpret_cast<const float4*>(row + (4 - h0));
  lo = h0 ? w : u;
  hi = h0 ? u : w;
}

// One block tile (kThreads threads): C[pr, n] for the tile's pair rows
// (pq: NP entries p | q << 8, row-major over p <= q, the first npr
// valid; those past them are never read) and lanes n in [lane0, lane0 +
// kLT), over t in [t_begin, t_end).
//   x: the group's GB design rows (fp32), row stride ldx; vec_x: rows and
//      base 16-byte aligned and t_begin a multiple of 4.
//   om: omega as bf16 bits, (T, ldo) with ldo a multiple of 8 and lanes
//      past N zero (or past ldo, zero-filled here).
//   out: row pr at out + pr * ldc; lanes >= N are not written.
//   smem: smem_bytes<NP>(GB) bytes of dynamic shared memory.
//   kSr: Z rounded stochastically (sr_bf16x2) instead of to nearest even,
//      by the Philox draw with counter (t / 8, row0 + pr, offset) and key
//      seed (row0: the group's packed row of the tile's first entry;
//      t_begin a multiple of 8).
template <int NP = kNP, bool kSr = false>
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ x, int ldx, int GB, bool vec_x,
    const uint16_t* __restrict__ om, int ldo, int N, int t_begin, int t_end,
    int lane0, const uint16_t* __restrict__ pq, int npr,
    float* __restrict__ out, size_t ldc, uint8_t* smem_raw, int row0 = 0,
    unsigned long long seed = 0, unsigned long long offset = 0) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  uint8_t* oms = smem;                                // [kStages][2][64][128B]
  constexpr int kA = NP / 2;                          // accumulators
  constexpr int kZB = NP * 128;                       // one Z buffer
  // Z rows per thread group of 8 (one chunk each) in the build.
  constexpr int kZRows = (NP + kThreads / 8 - 1) / (kThreads / 8);
  uint8_t* zs = oms + kStages * kOmStage;             // [2][NP][128B]
  float* xs = reinterpret_cast<float*>(zs + 2 * kZB);     // [kStages][GB][kKS]
  const uint32_t oms_a = (uint32_t)__cvta_generic_to_shared(oms);
  const uint32_t zs_a = (uint32_t)__cvta_generic_to_shared(zs);
  const int tid = threadIdx.x, wg = tid / 128;
  const int nst = t_end > t_begin ? (t_end - t_begin + kKS - 1) / kKS : 0;

  // Z build: thread (zg, zc) forms chunk zc (steps 8 zc .. 8 zc + 7) of
  // the pair rows zg kZRows .. zg kZRows + kZRows - 1, walking (p, q) in
  // the packed order from the row's table entry.
  const int zc = tid % 8, zg = tid / 8, zn0 = zg * kZRows;
  const int zh0 = (zc & 4) ? 4 : 0;
  int zp0 = 0, zq0 = 0;
  if (zn0 < npr) {
    const uint16_t e = pq[zn0];
    zp0 = e & 0xFF;
    zq0 = e >> 8;
  }

  auto load_stage = [&](int s) {
    const int t0 = t_begin + s * kKS, slot = s % kStages;
    uint8_t* od = oms + slot * kOmStage;
#pragma unroll
    for (int j = 0; j < kOmStage / 16 / kThreads; ++j) {
      const int c = tid + kThreads * j;
      const int slab = c / 512, k = (c % 512) / 8, ch = c % 8;
      const int t = t0 + k, n = lane0 + 64 * slab + 8 * ch;
      const bool ok = t < t_end && n < ldo;
      cp_async16(od + slab * kOmSlab + sw128(k, ch),
                 ok ? om + (size_t)t * ldo + n : om, ok);
    }
    float* xd = xs + slot * GB * kKS;
    if (vec_x) {
      for (int c = tid; c < GB * kKS / 4; c += kThreads) {
        const int r = c / (kKS / 4), k = (c % (kKS / 4)) * 4, t = t0 + k;
        const bool ok = t < t_end;
        cp_async16(xd + r * kKS + k, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    } else {
      for (int e = tid; e < GB * kKS; e += kThreads) {
        const int r = e / kKS, t = t0 + e % kKS;
        const bool ok = t < t_end;
        cp_async4(xd + e, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    }
  };

  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  auto build_z = [&](int s) {
    const float* xsrc = xs + (s % kStages) * GB * kKS + 8 * zc;
    uint8_t* zb = zs + (s & 1) * kZB;
    int p = zp0, q = zq0, pc = -1;
    float4 a0, a1;
#pragma unroll 1
    for (int i = 0; i < kZRows; ++i) {
      const int n = zn0 + i;
      if (n >= NP) break;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < npr) {
        if (p != pc) {
          load8(xsrc + p * kKS, zh0, a0, a1);
          pc = p;
        }
        float4 b0, b1;
        load8(xsrc + q * kKS, zh0, b0, b1);
        if constexpr (kSr) {
          // The chunk's 8 steps are one Philox draw: step 2 i + h rounds by
          // half h of word i.
          const uint4 r = philox(
              make_uint4((uint32_t)((t_begin + s * kKS) >> 3) + zc,
                         (uint32_t)(row0 + n), (uint32_t)offset,
                         (uint32_t)(offset >> 32)),
              key);
          v = make_uint4(sr_bf16x2(a0.x * b0.x, a0.y * b0.y, r.x),
                         sr_bf16x2(a0.z * b0.z, a0.w * b0.w, r.y),
                         sr_bf16x2(a1.x * b1.x, a1.y * b1.y, r.z),
                         sr_bf16x2(a1.z * b1.z, a1.w * b1.w, r.w));
        } else {
          v = make_uint4(bf16x2(a0.x * b0.x, a0.y * b0.y),
                         bf16x2(a0.z * b0.z, a0.w * b0.w),
                         bf16x2(a1.x * b1.x, a1.y * b1.y),
                         bf16x2(a1.z * b1.z, a1.w * b1.w));
        }
        if (++q == GB) q = ++p;
      }
      *reinterpret_cast<uint4*>(zb + sw128(n, zc)) = v;
    }
  };

  float acc[kA], sum[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) acc[i] = sum[i] = 0.0f;

  // Prologue: stages 0 .. kStages - 2 in flight; Z of stage 0 formed once
  // stages 0 and 1 have landed.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 3>();
  __syncthreads();
  if (nst > 0) build_z(0);
  fence_proxy_async();
  __syncthreads();

  const uint32_t slab_a = oms_a + wg * kOmSlab;
  for (int s = 0; s < nst; ++s) {
    // Z of stage s is formed, omega of stage s and the design rows of
    // stage s + 1 have landed, all visible to the tensor cores; the
    // products of stage s - 1 are done.
    const uint32_t a = slab_a + (s % kStages) * kOmStage;
    const uint32_t b = zs_a + (s & 1) * kZB;
    fence_acc(acc);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) mma(acc, desc_a(a, kk), desc_b(b, kk));
    mma_commit();
    // While the tensor cores run stage s: Z of stage s + 1 (into the
    // buffer stage s - 1 read), then stage s + 2 landed (this thread's
    // copies), the barrier, and the copies of stage s + kStages - 1 into
    // the slot of stage s - 1.
    if (s + 1 < nst) build_z(s + 1);
    cp_async_wait<kStages - 4>();
    fence_proxy_async();
    __syncthreads();
    if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
    cp_async_commit();
    mma_wait<0>();
    fence_acc(acc);
    if ((s + 1) % kFold == 0) {
      // sum + acc = t + e exactly (Fast2Sum; exact while |sum| >= |acc|,
      // as for the Gram's nonnegative terms after the first fold): sum
      // takes t, and the rounding error e seeds the next chunk.
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const float u = sum[i], v = acc[i], t = u + v;
        sum[i] = t;
        acc[i] = v - (t - u);
      }
    }
  }
  cp_async_wait<0>();

  const int t128 = tid % 128, w = t128 / 32, l = t128 % 32;
  const int m = lane0 + 64 * wg + 16 * w + l / 4;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = 8 * j + 2 * (l % 4) + (e & 1);
      const int n = m + 8 * (e >> 1);
      if (pr < npr && n < N)
        out[(size_t)pr * ldc + n] = sum[4 * j + e] + acc[4 * j + e];
    }
}

// ---------------------------------------------------------------------------
// The 3xTF32 mode (precision "high"): the same tile with fp32 operands,
//
//   C[pr, n] = sum_{t_begin <= t < t_end} Z[pr, t] om[t, n],  Z = X_p X_q,
//
// to about fp32 accuracy, in the arithmetic of the mma.sync loop it
// replaced (copy_reduce::split): Z and omega are split as hi = tf32(x) (to nearest)
// and lo = x - hi, and each product is lo.hi + hi.lo + hi.hi, the small
// terms first, three m64nNPk8 TF32 products per 8-step slice; the fp32
// accumulators are folded into a second sum by Fast2Sum every kFold3
// stages (64 steps), since the tensor cores truncate as they add. It
// replaces the JAX package's bf16x3 bodies (ss_pallas.py::_mm3 in the
// fused and the mesh kernels, gram_pallas.py::_gram_kernel_f32).
//   - A (omega, the lanes as wgmma's M) comes from registers: a TF32
//     operand read from shared memory must be K-major, and omega's stage is
//     lane-major. Each thread loads its own fragments (each omega value of a
//     stage is read by one thread) from an fp32 stage of padded rows (kOS3:
//     conflict-free) and splits them in registers, so omega costs no extra
//     bytes and no second layout. The 32 registers of a stage's fragments
//     stay live while the products run, beside 2 x NP / 2 sums.
//   - B holds Z_hi and Z_lo, two K-major 128-byte-swizzled tiles of NP rows
//     x 32 steps (a 128-byte line holds 32 TF32 steps), double-buffered;
//     the block forms them from the fp32 design rows while the tensor cores
//     run the previous stage, each thread one 16-byte chunk (4 steps) of a
//     run of pair rows, X_p's chunk kept in registers, the rows unrolled.
//   - Tiles of NP pair rows: 120 for K6 (GB = 40's 820 pairs in 7 tiles, 840
//     rows), 136 for K2 (GB = 32's 528 pairs in 4 tiles, 544 rows). The
//     registers bound NP: 255 a thread, none spilled, at 120 (64 bytes at
//     136); 144 rows (6 tiles for K6) spilled 104 bytes and ran slower.
//   - The ring holds kStages3 stages of omega (17 KB each) and of the design
//     rows (GB x 32 steps), as the bf16 body's does.
//   - What sets the pace (H100, config 5, time_group_gram.py --cut): the
//     copies alone run 32.0 ms (~5 TB/s from L2: each of the 7 pair tiles
//     reads the fp32 omega slab again), copies + products 74.1, copies +
//     build 55.6, all of it 94.5; the products alone (no copies, no build)
//     48.4 ms, 82% of the TF32 peak. The build and the copies each add ~20
//     ms to the products rather than hiding under them: the tensor cores
//     read B three times a slice (64 bytes a clock at their peak), which
//     leaves half of shared memory's bandwidth to the build's stores, the
//     copies and the A fragments. A ring of 6 stages changed nothing (94.1
//     ms); the build's rows unrolled saved 5%. Folding every 64 instead of
//     128 steps costs 4% (90.0 ms at 128) and halves the distance from a
//     float64 Gram (3.2e-7 against 5.5e-7; cuBLAS SGEMM 6.3e-7).
constexpr int kKS3 = 32;                      // time steps per stage
constexpr int kOS3 = kLT + 8;                 // omega stage row stride
constexpr int kOmStage3 = kKS3 * kOS3 * 4;    // bytes of one omega stage
constexpr int kFold3 = 2;                     // stages per fold (64 steps)
constexpr int kStages3 = 5;                   // ring depth, as kStages

// Shared memory of a 3xTF32 tile of NP pair rows, in bytes: the Z_hi / Z_lo
// buffers (on 1024-byte boundaries), the omega stages, the design stages.
template <int NP>
__host__ __device__ constexpr int smem_bytes_tf32(int GB) {
  return 1024 + 4 * NP * 128 + kStages3 * (kOmStage3 + GB * kKS3 * 4);
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The A fragments of one stage, split: o points at the thread's lane and
// step in an fp32 omega stage of row stride kOS3 (step k, lane m at
// o[k kOS3 + m]); ah / al[kk] hold slice kk's hi and lo (mma_tf32's a).
__device__ __forceinline__ void load_a_tf32(const float* o,
                                            uint32_t (&ah)[kKS3 / 8][4],
                                            uint32_t (&al)[kKS3 / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kKS3 / 8; ++kk) {
    const float* f = o + 8 * kk * kOS3;
    copy_reduce::split(f[0], ah[kk][0], al[kk][0]);
    copy_reduce::split(f[8], ah[kk][1], al[kk][1]);
    copy_reduce::split(f[4 * kOS3], ah[kk][2], al[kk][2]);
    copy_reduce::split(f[4 * kOS3 + 8], ah[kk][3], al[kk][3]);
  }
}

// The three products of one stage's 4 slices, small terms first: zh, zl
// the shared addresses of the stage's Z_hi and Z_lo tiles.
template <int A>
__device__ __forceinline__ void products_tf32(float (&d)[A],
                                              const uint32_t (&ah)[4][4],
                                              const uint32_t (&al)[4][4],
                                              uint32_t zh, uint32_t zl) {
#pragma unroll
  for (int kk = 0; kk < kKS3 / 8; ++kk) {
    mma_tf32(d, al[kk], desc_b(zh, kk));
    mma_tf32(d, ah[kk], desc_b(zl, kk));
    mma_tf32(d, ah[kk], desc_b(zh, kk));
  }
}

// One block tile in the 3xTF32 mode: C[pr, n] for the tile's pair rows
// (pq and npr as in gram_tile) and lanes n in [lane0, lane0 + kLT), over t
// in [t_begin, t_end).
//   x: the group's GB design rows (fp32), row stride ldx; vec_x: rows and
//      base 16-byte aligned and t_begin a multiple of 4.
//   om: omega, fp32 (T, N), row stride N; vec_o: N a multiple of 4 and the
//      base 16-byte aligned. Lanes past N and steps past t_end read 0.
//   out: row pr at out + pr * ldc; lanes >= N are not written.
//   smem: smem_bytes_tf32<NP>(GB) bytes of dynamic shared memory.
template <int NP>
__device__ __forceinline__ void gram_tile_tf32(
    const float* __restrict__ x, int ldx, int GB, bool vec_x,
    const float* __restrict__ om, int N, bool vec_o, int t_begin, int t_end,
    int lane0, const uint16_t* __restrict__ pq, int npr,
    float* __restrict__ out, size_t ldc, uint8_t* smem_raw) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* smem = smem_raw + ((1024u - (raw & 1023u)) & 1023u);
  constexpr int kA = NP / 2;                          // accumulators
  constexpr int kZB = NP * 128;                       // one Z tile
  constexpr int kZRows = (NP + kThreads / 8 - 1) / (kThreads / 8);
  uint8_t* zs = smem;                                 // [2][hi, lo][NP][128B]
  float* oms = reinterpret_cast<float*>(zs + 4 * kZB);  // [kStages3][kKS3]
  float* xs = oms + kStages3 * kKS3 * kOS3;         // [kStages3][GB][kKS3]
  const uint32_t zs_a = (uint32_t)__cvta_generic_to_shared(zs);
  const int tid = threadIdx.x, wg = tid / 128;
  const int nst = t_end > t_begin ? (t_end - t_begin + kKS3 - 1) / kKS3 : 0;

  // Z build: thread (zg, zc) forms chunk zc (steps 4 zc .. 4 zc + 3) of the
  // pair rows zg kZRows .. zg kZRows + kZRows - 1, walking (p, q) in the
  // packed order from the row's table entry.
  const int zc = tid % 8, zg = tid / 8, zn0 = zg * kZRows;
  int zp0 = 0, zq0 = 0;
  if (zn0 < npr) {
    const uint16_t e = pq[zn0];
    zp0 = e & 0xFF;
    zq0 = e >> 8;
  }

  auto load_stage3 = [&](int s) {
    const int t0 = t_begin + s * kKS3, slot = s % kStages3;
    float* od = oms + slot * kKS3 * kOS3;
    if (vec_o) {
#pragma unroll
      for (int j = 0; j < kKS3 * kLT / 4 / kThreads; ++j) {
        const int c = tid + kThreads * j;
        const int k = c / (kLT / 4), n4 = (c % (kLT / 4)) * 4;
        const int t = t0 + k, n = lane0 + n4;
        const bool ok = t < t_end && n < N;
        cp_async16(od + k * kOS3 + n4, ok ? om + (size_t)t * N + n : om, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKS3 * kLT / kThreads; ++j) {
        const int e = tid + kThreads * j;
        const int k = e / kLT, l = e % kLT;
        const int t = t0 + k, n = lane0 + l;
        const bool ok = t < t_end && n < N;
        cp_async4(od + k * kOS3 + l, ok ? om + (size_t)t * N + n : om, ok);
      }
    }
    float* xd = xs + slot * GB * kKS3;
    if (vec_x) {
      for (int c = tid; c < GB * kKS3 / 4; c += kThreads) {
        const int r = c / (kKS3 / 4), k = (c % (kKS3 / 4)) * 4, t = t0 + k;
        const bool ok = t < t_end;
        cp_async16(xd + r * kKS3 + k, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    } else {
      for (int e = tid; e < GB * kKS3; e += kThreads) {
        const int r = e / kKS3, t = t0 + e % kKS3;
        const bool ok = t < t_end;
        cp_async4(xd + e, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    }
  };

  auto build_z3 = [&](int s) {
    const float* xsrc = xs + (s % kStages3) * GB * kKS3 + 4 * zc;
    uint8_t* zh = zs + (s & 1) * 2 * kZB;
    int p = zp0, q = zq0, pc = -1;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kZRows; ++i) {
      const int n = zn0 + i;
      if (n >= NP) break;
      uint4 h = make_uint4(0u, 0u, 0u, 0u), l = h;
      if (n < npr) {
        if (p != pc) {
          a = *reinterpret_cast<const float4*>(xsrc + p * kKS3);
          pc = p;
        }
        const float4 b = *reinterpret_cast<const float4*>(xsrc + q * kKS3);
        copy_reduce::split(a.x * b.x, h.x, l.x);
        copy_reduce::split(a.y * b.y, h.y, l.y);
        copy_reduce::split(a.z * b.z, h.z, l.z);
        copy_reduce::split(a.w * b.w, h.w, l.w);
        if (++q == GB) q = ++p;
      }
      *reinterpret_cast<uint4*>(zh + sw128(n, zc)) = h;
      *reinterpret_cast<uint4*>(zh + kZB + sw128(n, zc)) = l;
    }
  };

  float acc[kA], sum[kA];
#pragma unroll
  for (int i = 0; i < kA; ++i) acc[i] = sum[i] = 0.0f;

  // Prologue: stages 0 .. kStages3 - 2 in flight; Z of stage 0 formed once
  // stages 0 and 1 have landed.
#pragma unroll
  for (int s = 0; s < kStages3 - 1; ++s) {
    if (s < nst) load_stage3(s);
    cp_async_commit();
  }
  cp_async_wait<kStages3 - 3>();
  __syncthreads();
  if (nst > 0) build_z3(0);
  fence_proxy_async();
  __syncthreads();

  // The thread's A fragment: lanes 64 wg + 16 w + l / 4 (+ 8), steps l % 4
  // (+ 4) of each slice.
  const int t128 = tid % 128, w = t128 / 32, l = t128 % 32;
  const float* oa = oms + (l % 4) * kOS3 + 64 * wg + 16 * w + l / 4;
  for (int s = 0; s < nst; ++s) {
    // Z of stage s is formed and visible to the tensor cores, omega of
    // stage s and the design rows of stage s + 1 have landed; the products
    // of stage s - 1 are done.
    uint32_t ah[kKS3 / 8][4], al[kKS3 / 8][4];
    load_a_tf32(oa + (s % kStages3) * kKS3 * kOS3, ah, al);
    const uint32_t zh = zs_a + (s & 1) * 2 * kZB;
    fence_acc(acc);
    fence_regs(ah);
    fence_regs(al);
    mma_fence();
    products_tf32(acc, ah, al, zh, zh + kZB);
    mma_commit();
    // While the tensor cores run stage s: Z of stage s + 1 (into the
    // buffers stage s - 1 read), then stage s + 2 landed, the barrier, and
    // the copies of stage s + kStages3 - 1 into the slot of stage s - 1.
    if (s + 1 < nst) build_z3(s + 1);
    cp_async_wait<kStages3 - 4>();
    fence_proxy_async();
    __syncthreads();
    if (s + kStages3 - 1 < nst) load_stage3(s + kStages3 - 1);
    cp_async_commit();
    mma_wait<0>();
    fence_acc(acc);
    fence_regs(ah);
    fence_regs(al);
    if ((s + 1) % kFold3 == 0) {
      // Fast2Sum, as in gram_tile.
#pragma unroll
      for (int i = 0; i < kA; ++i) {
        const float u = sum[i], v = acc[i], t = u + v;
        sum[i] = t;
        acc[i] = v - (t - u);
      }
    }
  }
  cp_async_wait<0>();

  const int m = lane0 + 64 * wg + 16 * w + l / 4;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pr = 8 * j + 2 * (l % 4) + (e & 1);
      const int n = m + 8 * (e >> 1);
      if (pr < npr && n < N)
        out[(size_t)pr * ldc + n] = sum[4 * j + e] + acc[4 * j + e];
    }
}

}  // namespace gram_wgmma
