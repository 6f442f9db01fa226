// Helpers shared by the kernels that stage operands through shared memory
// and split the time axis (K2 in ss_group_pass.cu, K6 in group_gram.cu and
// the 3xTF32 Gram in gram_wgmma.cuh::gram_tile_tf32):
// cp.async copies of 16 or 4 bytes (zero-filled where `ok` is false), the
// split of an fp32 value into two TF32 operands, and the ordered,
// compensated sum of a split's partials.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace copy_reduce {

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
// split, not the tensor cores, set the pace of an mma.sync loop).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo exactly, hi the TF32 nearest x: the operands of 3xTF32, whose
// products a.b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi keep ~fp32 accuracy. The
// tensor cores read only the TF32 bits of lo, i.e. lo cut toward zero: an
// error below 2^-22 |x| whose sign follows lo's, which is as often
// negative as positive.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// out[i] = sum over splits of part[split, i], in split order, compensated
// (each add's rounding error, recovered by TwoSum, is carried to the end).
static __global__ void reduce_splits_kernel(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            int n_split, long long stride,
                                            long long count) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.0f, c = 0.0f;
  for (int k = 0; k < n_split; ++k) {
    const float b = part[k * stride + i], t = s + b, bb = t - s;
    c += (s - (t - bb)) + (b - bb);
    s = t;
  }
  out[i] = s + c;
}

// reduce_splits_kernel over `count` outputs, on stream s.
static inline cudaError_t reduce_splits(const float* part, float* out,
                                        int n_split, long long stride,
                                        long long count, cudaStream_t s) {
  const int threads = 256;
  reduce_splits_kernel<<<(unsigned)((count + threads - 1) / threads), threads,
                         0, s>>>(part, out, n_split, stride, count);
  return cudaGetLastError();
}

}  // namespace copy_reduce
