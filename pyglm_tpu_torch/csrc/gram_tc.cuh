// The tensor-core tile loop shared by K2 (ss_group_pass.cu) and K6
// (group_gram.cu): one thread block computes one tile of
//
//   C[pr, n] = sum_{t_begin <= t < t_end} Z[pr, t] B[t, n]
//
// where Z[pr, t] = X[p, t] X[q, t] over the packed pair rows pr -> (p, q),
// p <= q, of one group's GB design rows and B = omega (the Gram), or
// Z = X and B = u (K2's gather M0 = X_g u); kMT rows by kNT postsyn lanes.
//
// Arithmetic (precision "high"): each operand x is split as hi = tf32(x)
// (rounded to nearest, as cvt.rna) and lo = x - hi (which the tensor cores
// read as TF32), and every product is a.b ~ a_lo b_hi + a_hi b_lo + a_hi
// b_hi: three mma.sync.m16n8k8 TF32 products accumulated in fp32, small
// terms first. That is ~fp32 accuracy; the JAX package's "high" is the
// same trick in bf16x3 on the TPU's matrix unit. (The bf16 and SR Grams of
// "default" and "sr" run on wgmma, gram_wgmma.cuh.) The tensor cores add
// into their fp32 accumulator with truncation (a one-sided error that
// grows with the number of adds: 7.6e-5 relative over T = 2e4 on the
// H100), so the accumulator is folded into a second fp32 sum every `fold`
// stages, chosen by the caller, by a Fast2Sum whose rounding error seeds
// the next chunk: the truncated chains stay short and the folds add almost
// no error.
//
// Data movement: a ring of kStages shared-memory stages, each kKT time steps
// of the GB design rows and of a (kKT, kNT) omega tile, filled by cp.async
// (16-byte copies where rows are 16-byte aligned, 4-byte copies otherwise;
// the ragged T and lane edges are zero-filled by the copy itself). Z[pr, t]
// = X[p, t] X[q, t] is formed once per stage by the whole block into a
// double-buffered shared tile (never in device memory), after the block's
// products of the previous stage, so it overlaps slower warps' products.
// The warps read their A fragments from it and their B fragments from the
// omega stage, one k-step ahead of the products, and split them in
// registers. One __syncthreads() per stage.
//
// What bounds it on the H100: mma.sync TF32 peaks near 310 TFLOP/s (about
// 65% of the card's dense TF32 peak of 495), so 3xTF32 is bounded near 100
// TFLOP/s of fp32 work (diagnostics/mma_peak.py); beside it the loads,
// the split, the Z build and the barrier, which do not overlap the products
// well (PERF.md).
// Tiles: 64 pair rows x 128 lanes over 8 warps (2 along rows x 4 along
// lanes), each warp 2 x 4 fragments of 16 x 8 (its lane fragments dealt
// round robin, see gram_tile); a warp skips the fragments
// that lie wholly past the last pair row or lane, so padding costs no
// tensor-core work (K2's 528 pairs are exactly 33 fragments of 16 and K6's
// 820 fit in 52), and a warp with all its fragments valid makes its
// products with no tests between them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gram_tc {

constexpr int kMT = 64;          // rows of Z per block tile
constexpr int kNT = 128;         // postsyn lanes per block tile
constexpr int kKT = 32;          // time steps per ring stage (4 k-steps)
constexpr int kStages = 4;       // ring depth: 2 stages in flight
constexpr int kThreads = 256;    // 8 warps, 2 x 4 fragments each
constexpr int kMaxGB = 64;
constexpr int kZS = kKT + 4;     // Z row stride: conflict-free A fragments
constexpr int kOS = kNT + 8;     // omega row stride: conflict-free B fragments

__host__ __device__ constexpr int smem_floats(int GB) {
  return kStages * (GB * kKT + kKT * kOS) + 2 * kMT * kZS;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// x rounded to TF32, to nearest with ties away from zero: the result of
// cvt.rna.tf32.f32 for finite x, in two integer operations at full rate
// (the conversion instruction runs at a fraction of that, and with it the
// split, not the tensor cores, set the pace).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo exactly, hi the TF32 nearest x. The tensor cores read only
// the TF32 bits of lo, i.e. lo cut toward zero: an error below 2^-22 |x|
// whose sign follows lo's, which is as often negative as positive.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one 16 x 8 x 8 TF32 fragment product, fp32 accumulate.
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3 x (2 x 4) products of one k-step, small terms first. kFull: all
// of the warp's fragments hold valid rows and lanes, so no test is made
// (tests between the products would keep the compiler from interleaving
// the independent accumulators).
template <bool kFull>
__device__ __forceinline__ void products(float (&acc)[2][4][4],
                                         const uint32_t (&ah)[2][4],
                                         const uint32_t (&al)[2][4],
                                         const uint32_t (&bh)[4][2],
                                         const uint32_t (&bl)[4][2], int mf,
                                         int nf) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kFull || (i < mf && j < nf)) mma(acc[i][j], al[i], bh[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kFull || (i < mf && j < nf)) mma(acc[i][j], ah[i], bl[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (kFull || (i < mf && j < nf)) mma(acc[i][j], ah[i], bh[j]);
}

// One block tile. x: the group's GB design rows, row stride ldx; om: (T, N)
// omega, row stride N; out: row pr of the packed Gram at out + pr * N.
// pairs = false computes X om instead (npair = GB rows, Z = X), the same
// loop with another B operand: K2's gather M0 = X_g u.
// vec_x / vec_o: the rows of x / om (and their base) are 16-byte aligned.
// fold: stages between folds of the tensor-core accumulators into the
// second fp32 sum. smem: smem_floats(GB) floats of dynamic shared memory.
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ x, int ldx, int GB, bool pairs,
    const float* __restrict__ om, int N, int t_begin, int t_end, int lane0,
    int row0, int npair, bool vec_x, bool vec_o, int fold,
    float* __restrict__ out, float* smem) {
  float* xs = smem;                                   // [kStages][GB][kKT]
  float* os = xs + kStages * GB * kKT;                // [kStages][kKT][kOS]
  float* zs = os + kStages * kKT * kOS;               // [2][kMT][kZS]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;           // fragment coordinates
  const int wm = warp / 4, wn = warp % 4;
  const int nst = t_end > t_begin ? (t_end - t_begin + kKT - 1) / kKT : 0;

  // Fragments of this warp that hold valid rows / lanes (uniform per warp).
  // Lanes are dealt to the warps by fragment, round robin: warp wn owns the
  // fragments 4 j + wn, so a ragged last lane tile (72 lanes at N = 200)
  // spreads over all four SM sub-partitions (warp w runs on w % 4).
  const int wrow = row0 + 32 * wm, wlane = lane0 + 8 * wn;
  const int mf = min(2, max(0, (npair - wrow + 15) / 16));
  const int nf = min(4, max(0, (N - wlane + 31) / 32));
  const bool full = mf == 2 && nf == 4;

  // Z rows: thread tid forms Z[zr, zk .. zk + kZE - 1] of every stage: the
  // product of design rows zp and zq, or design row zp itself (zq < 0).
  constexpr int kZE = kMT * kKT / kThreads;
  const int zr = tid / (kKT / kZE), zk = (tid % (kKT / kZE)) * kZE;
  int zp = -1, zq = -1;
  if (row0 + zr < npair) {
    int rem = row0 + zr;
    zp = 0;
    if (pairs) {
      while (rem >= GB - zp) {
        rem -= GB - zp;
        ++zp;
      }
      zq = zp + rem;
    } else {
      zp = rem;
    }
  }

  auto load_stage = [&](int s) {
    const int t0 = t_begin + s * kKT, slot = s % kStages;
    float* xd = xs + slot * GB * kKT;
    float* od = os + slot * kKT * kOS;
    if (vec_x) {
      for (int c = tid; c < GB * kKT / 4; c += kThreads) {
        const int r = c / (kKT / 4), k = (c % (kKT / 4)) * 4, t = t0 + k;
        const bool ok = t < t_end;
        cp_async16(xd + r * kKT + k, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    } else {
      for (int e = tid; e < GB * kKT; e += kThreads) {
        const int r = e / kKT, t = t0 + e % kKT;
        const bool ok = t < t_end;
        cp_async4(xd + e, ok ? x + (size_t)r * ldx + t : x, ok);
      }
    }
    if (vec_o) {
#pragma unroll
      for (int j = 0; j < kKT * kNT / 4 / kThreads; ++j) {
        const int c = tid + kThreads * j;
        const int k = c / (kNT / 4), n4 = (c % (kNT / 4)) * 4;
        const int t = t0 + k, n = lane0 + n4;
        const bool ok = t < t_end && n < N;
        cp_async16(od + k * kOS + n4, ok ? om + (size_t)t * N + n : om, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKT * kNT / kThreads; ++j) {
        const int e = tid + kThreads * j;
        const int k = e / kNT, l = e % kNT;
        const int t = t0 + k, n = lane0 + l;
        const bool ok = t < t_end && n < N;
        cp_async4(od + k * kOS + l, ok ? om + (size_t)t * N + n : om, ok);
      }
    }
  };

  // Z of stage s, formed once per block.
  auto build_z = [&](int s) {
    const float* xsrc = xs + (s % kStages) * GB * kKT;
#pragma unroll
    for (int h = 0; h < kZE; h += 4) {
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (zp >= 0) {
        z = *reinterpret_cast<const float4*>(xsrc + zp * kKT + zk + h);
        if (zq >= 0) {
          const float4 b =
              *reinterpret_cast<const float4*>(xsrc + zq * kKT + zk + h);
          z = make_float4(z.x * b.x, z.y * b.y, z.z * b.z, z.w * b.w);
        }
      }
      *reinterpret_cast<float4*>(zs + ((s & 1) * kMT + zr) * kZS + zk + h) =
          z;
    }
  };

  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.0f;

  // Raw fragments of one k-step: A (2 x 4 values of Z), B (4 x 2 of omega).
  float ar[2][4], br[4][2];
  auto load_frags = [&](const float* zb, const float* ob, int kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* zf = zb + (16 * i + gid) * kZS + kk + tig;
      ar[i][0] = zf[0], ar[i][1] = zf[8 * kZS];
      ar[i][2] = zf[4], ar[i][3] = zf[8 * kZS + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* of = ob + (kk + tig) * kOS + 32 * j + gid;
      br[j][0] = of[0], br[j][1] = of[4 * kOS];
    }
  };

  // Prologue: stages 0 .. kStages - 2 in flight, Z of stage 0 formed.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (nst > 0) build_z(0);

  for (int s = 0; s < nst; ++s) {
    // Stage s + 1 has landed; Z of stage s is formed; every warp is done
    // with stage s - 1, whose ring slot and Z buffer are now free.
    cp_async_wait<kStages - 3>();
    __syncthreads();
    if (s + kStages - 1 < nst) load_stage(s + kStages - 1);
    cp_async_commit();

    if (mf > 0 && nf > 0) {
      const float* zb = zs + ((s & 1) * kMT + 32 * wm) * kZS;
      const float* ob = os + (s % kStages) * kKT * kOS + 8 * wn;
      load_frags(zb, ob, 0);
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 8) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) split(ar[i][e], ah[i][e], al[i][e]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) split(br[j][e], bh[j][e], bl[j][e]);
        if (kk + 8 < kKT) load_frags(zb, ob, kk + 8);
        if (full)
          products<true>(acc, ah, al, bh, bl, mf, nf);
        else
          products<false>(acc, ah, al, bh, bl, mf, nf);
      }
    }
    // Z of the next stage, while slower warps still run their products.
    if (s + 1 < nst) build_z(s + 1);
    if ((s + 1) % fold == 0) {
      // sum + acc = t + e exactly (Fast2Sum; exact while |sum| >= |acc|,
      // as for the Gram's nonnegative terms after the first fold): sum
      // takes t, and the rounding error e seeds the next chunk's
      // accumulator, so the folds add almost no error of their own.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = sum[i][j][e], b = acc[i][j][e], t = a + b;
            sum[i][j][e] = t;
            acc[i][j][e] = b - (t - a);
          }
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at (gid, 2 tig + {0, 1}); c2, c3 at row gid + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pr = wrow + 16 * i + gid + (e >= 2 ? 8 : 0);
        const int n = wlane + 32 * j + 2 * tig + (e & 1);
        if (pr < npair && n < N)
          out[(size_t)pr * N + n] = sum[i][j][e] + acc[i][j][e];
      }
}

}  // namespace gram_tc
