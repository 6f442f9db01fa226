// K1: exact Polya-Gamma PG(1, c) draws by Devroye's alternating-series
// rejection sampler, one thread per element.
//
// Replaces the TPU kernel pyglm_tpu/ops/pg_pallas.py::_pg_kernel (launched
// by _kernel_pass from pg_devroye_pallas) together with its straggler
// finisher (_finish_by_extraction + _pg_draw_small). The TPU kernel runs a
// fixed two proposal rounds per element and hands the ~1e-5 that fail to a
// compacting finisher. Here each thread simply loops until it accepts; a
// warp waits for its slowest lane, which at a per-round acceptance above
// 0.99 costs a few rounds at most. After kMaxRounds rounds (probability
// below 1e-300) the thread returns the conditional mean tanh(z)/z.
//
// Bound on the H100: transcendental throughput (log/exp/sqrt per round)
// and warp divergence between the exponential and the truncated inverse-
// Gaussian branch, not memory: 20M elements move 160 MB (about 50 us at
// 3.35 TB/s) while every element evaluates tens of transcendentals. The
// design keeps all state in registers, draws from a counter-based Philox
// stream (curand_kernel.h, a header) so no generator state touches device
// memory, and reads/writes each element once.
//
// Numerics kept from the TPU kernel: the mixture weight
// q = 2 [e^{-z} Phi((zt-1)/sqrt t) + e^{z} Phi(-(zt+1)/sqrt t)] is formed in
// log space in double precision (e^{z} Phi(-x) must not overflow), and the
// clamps of the Michael-Schucany-Haas branch stay. The series test runs the
// standard alternating loop, normalised by a_0.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kT = 0.64f;            // proposal truncation point t
constexpr float kPi = 3.14159265358979f;
constexpr int kMaxRounds = 1000;
constexpr int kMaxSeries = 64;

// log Phi(x) in double precision, finite far into the lower tail.
__device__ double log_norm_cdf(double x) {
  if (x < 0.0) {
    // Phi(x) = erfc(-x / sqrt 2) / 2 = erfcx(-x / sqrt 2) e^{-x^2/2} / 2
    return log(0.5 * erfcx(-x * M_SQRT1_2)) - 0.5 * x * x;
  }
  return log1p(-0.5 * erfc(x * M_SQRT1_2));
}

// log a_n(x) - log a_0(x): the series coefficient ratio on either branch.
__device__ float log_coef_ratio(float x, int n) {
  const float h = n + 0.5f;
  if (x <= kT) {
    return logf(2.0f * h) - 2.0f * (h * h - 0.25f) / x;
  }
  return logf(2.0f * h) - 0.5f * (h * h - 0.25f) * kPi * kPi * x;
}

__device__ float uniform_open(curandStatePhilox4_32_10_t* st) {
  return curand_uniform(st);            // (0, 1]
}

__device__ float exponential(curandStatePhilox4_32_10_t* st) {
  return -logf(uniform_open(st));
}

// One proposal from the truncated inverse Gaussian IG(1/z, 1) on (0, t).
// Returns false when kMaxRounds inner rounds all reject; the caller then
// treats the outer round as rejected, which leaves the law exact.
__device__ bool trunc_inv_gauss(float z, curandStatePhilox4_32_10_t* st,
                                float* out) {
  if (z * kT < 1.0f) {
    // Tilted Levy rejection.
    for (int i = 0; i < kMaxRounds; ++i) {
      const float e1 = exponential(st);
      const float e2 = exponential(st);
      if (e1 * e1 > 2.0f * e2 / kT) continue;
      const float d = 1.0f + kT * e1;
      const float x = kT / (d * d);
      if (uniform_open(st) <= expf(-0.5f * z * z * x)) {
        *out = x;
        return true;
      }
    }
    return false;
  }
  // Michael-Schucany-Haas, retried until X <= t.
  const float mu = 1.0f / z;
  for (int i = 0; i < kMaxRounds; ++i) {
    const float n = curand_normal(st);
    const float muy = mu * n * n;
    float x = mu + 0.5f * mu * muy - 0.5f * mu * sqrtf(4.0f * muy + muy * muy);
    x = fmaxf(x, 1e-30f);
    if (uniform_open(st) > mu / (mu + x)) x = fminf(mu * mu / x, 1e30f);
    if (x <= kT) {
      *out = x;
      return true;
    }
  }
  return false;
}

__global__ void pg_devroye_kernel(const float* __restrict__ c,
                                  float* __restrict__ out, long long n,
                                  unsigned long long seed,
                                  unsigned long long offset) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  curandStatePhilox4_32_10_t st;
  curand_init(seed, (unsigned long long)i, offset, &st);

  const float z = 0.5f * fabsf(c[i]);
  // Mixture weight of the exponential branch, p / (p + q), in log space.
  const double zd = z;
  const double kd = kPi * (double)kPi / 8.0 + 0.5 * zd * zd;
  const double logp = log(kPi / (2.0 * kd)) - kd * kT;
  const double sqt = sqrt((double)kT);
  const double l1 = -zd + log_norm_cdf((zd * kT - 1.0) / sqt);
  const double l2 = zd + log_norm_cdf(-(zd * kT + 1.0) / sqt);
  const double lq = M_LN2 + fmax(l1, l2) + log1p(exp(-fabs(l1 - l2)));
  const double lm = fmax(logp, lq);
  const float ratio_exp =
      (float)exp(logp - (lm + log1p(exp(-fabs(logp - lq)))));
  const float K = (float)kd;

  const float zs = fmaxf(z, 1e-6f);
  float result = z < 1e-6f ? 1.0f : tanhf(zs) / zs;   // fallback: E[J*]
  for (int r = 0; r < kMaxRounds; ++r) {
    float x;
    if (uniform_open(&st) <= ratio_exp) {
      x = kT + exponential(&st) / K;
    } else if (!trunc_inv_gauss(z, &st, &x)) {
      continue;
    }
    x = fmaxf(x, 1e-30f);
    // Accept iff U <= S_n / a_0 for the first odd n with U <= S_n / a_0,
    // reject at the first even n with U > S_n / a_0.
    const float u = uniform_open(&st);
    float s = 1.0f;
    bool decided = false, accept = false;
    for (int k = 1; k <= kMaxSeries && !decided; ++k) {
      const float term = expf(log_coef_ratio(x, k));
      if (k & 1) {
        s -= term;
        if (u <= s) { decided = true; accept = true; }
      } else {
        s += term;
        if (u > s) { decided = true; }
      }
    }
    if (accept) {
      result = x;
      break;
    }
  }
  out[i] = 0.25f * result;
}

}  // namespace

extern "C" int pg_devroye_launch(const float* c, float* out, long long n,
                                 unsigned long long seed,
                                 unsigned long long offset, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  pg_devroye_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      c, out, n, seed, offset);
  return (int)cudaGetLastError();
}

extern "C" const char* pgt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
