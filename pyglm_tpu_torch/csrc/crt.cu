// K5: Chinese-restaurant-table counts l = sum_{i < y} Bern(r / (r + i)),
// one thread per element (grid-stride).
//
// Replaces the TPU kernel pyglm_tpu/ops/pg_pallas.py::_crt_kernel (launched
// by crt_sample_pallas). Mosaic had no per-lane loops, so the TPU kernel ran
// every element to max_y with masks; here each thread loops i < min(y,
// max_y), so the zeros that dominate count data cost one load and one store.
// r is indexed by column (element i reads r[i % N]) instead of being
// broadcast to the shape of y, which at (100000, 200) saves an 80 MB array.
//
// Bound on the H100: memory for sparse counts (8 bytes in and 4 out per
// element), one Philox uniform per table for the rest. Each element draws
// from its own Philox subsequence, so no generator state is stored.

#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

template <typename Y>
__global__ void crt_kernel(const Y* __restrict__ y,
                           const float* __restrict__ r, int* __restrict__ out,
                           long long n, int N, int max_y,
                           unsigned long long seed,
                           unsigned long long offset) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int yi = min((int)y[i], max_y);
    int l = 0;
    if (yi > 0) {
      const float ri = r[i % N];
      curandStatePhilox4_32_10_t st;
      curand_init(seed, (unsigned long long)i, offset, &st);
      // U in (0, 1], so P(U <= p) = p; i = 0 (p = 1) always seats a table.
      for (int k = 0; k < yi; ++k) l += curand_uniform(&st) <= ri / (ri + k);
    }
    out[i] = l;
  }
}

}  // namespace

extern "C" int crt_sample_launch(const void* y, int y_is_float,
                                 const float* r, int* out, long long n,
                                 int N, int max_y, unsigned long long seed,
                                 unsigned long long offset, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  cudaStream_t s = (cudaStream_t)stream;
  if (y_is_float) {
    crt_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)y, r, out, n, N, max_y, seed, offset);
  } else {
    crt_kernel<int><<<(unsigned)blocks, threads, 0, s>>>(
        (const int*)y, r, out, n, N, max_y, seed, offset);
  }
  return (int)cudaGetLastError();
}
