// K4: Polya-Gamma PG(b, c) for real b by the truncated gamma series, one
// thread per element (grid-stride).
//
//   PG(b, c) = 1/(2 pi^2) sum_k g_k / ((k - 1/2)^2 + a^2),  a = |c| / (2 pi),
//   g_k ~ Gamma(b) iid.
//
// The first kTerms terms are drawn exactly; the tail k > kTerms is one draw
// delta + Gamma(alpha) / beta whose first three moments match the tail's.
//
// Replaces the TPU kernel pyglm_tpu/ops/pg_pallas.py::_pg_gamma_kernel
// (launched by pg_gamma_series_pallas), the XLA-side tail parameters
// (_tail_alpha_beta, which needed atan, absent from Mosaic) and the
// straggler finisher (_finish_by_extraction + _pg_gamma_draw_small). The TPU
// kernel runs a fixed two Marsaglia-Tsang rounds per pair of terms with a
// shared proposal stream and hands the ~2e-5 of elements whose budget ran
// out to the finisher. Here each Gamma draw simply loops until it accepts:
// a thread has no stragglers, and a warp waits for its slowest lane, which
// at a per-round acceptance above 0.95 costs a few rounds. A draw that
// rejects kMaxRounds times in a row (probability below 1e-1000) keeps the
// mean of its Gamma, its shape.
//
// Regimes, chosen per element so each element is drawn once: b >= cutoff
// gives the normal approximation N(E, Var) floored at 1e-30 (cutoff 170 for
// the hybrid sampler, +inf for the plain series, -inf for "normal"); else
// b <= 0 gives 0; else the series with b+ = max(b, 1e-6).
//
// Bound on the H100: transcendental throughput and divergence, not memory.
// 20M elements move 240 MB (~70 us at 3.35 TB/s) while every element takes
// five Gamma draws (each a normal, a uniform, two logs, and for shape < 1
// a boost log/exp) and three atanf-based tail sums. State stays in
// registers; the counter-based Philox stream (curand_kernel.h) keeps no
// generator state in device memory.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>

namespace {

using Philox = curandStatePhilox4_32_10_t;

constexpr float kPi = 3.14159265358979f;
constexpr int kTerms = 4;              // _GAMMA_K of the TPU kernel
constexpr int kMaxRounds = 1000;

// Gamma(shape, 1) by Marsaglia-Tsang. shape < 1 draws Gamma(shape + 1) and
// boosts it by U^(1/shape), which underflows to 0 in float32 for tiny
// shapes, as the true Gamma(shape) mass near 0 does.
__device__ float gamma_draw(float shape, Philox* st) {
  const bool boost = shape < 1.0f;
  const float d = (boost ? shape + 1.0f : shape) - 1.0f / 3.0f;
  const float cm = 1.0f / (3.0f * sqrtf(d));
  for (int r = 0; r < kMaxRounds; ++r) {
    const float x = curand_normal(st);
    const float v0 = 1.0f + cm * x;
    if (v0 <= 0.0f) continue;
    const float v = v0 * v0 * v0;
    const float u = curand_uniform(st);            // (0, 1]
    if (logf(u) < 0.5f * x * x + d - d * v + d * logf(v)) {
      float g = d * v;
      if (boost) g *= expf(logf(curand_uniform(st)) / shape);
      return g;
    }
  }
  return shape;
}

// Sums over k > K of 1/d_k, 1/d_k^2, 1/d_k^3, d_k = (k - 1/2)^2 + a^2: the
// float32 formulas of pyglm_tpu/ops/polyagamma.py::_tail_sums (midpoint
// integrals, Taylor series below a = 0.5 where the exact S2/S3 cancel, and
// the first Euler-Maclaurin correction).
__device__ void tail_sums(float a, float* S1, float* S2, float* S3) {
  const float Kf = (float)kTerms;
  const float as = fmaxf(a, 1e-12f);
  const bool small = a < 0.5f;
  const float a2 = a * a, a4 = a2 * a2;
  const float aK = a / Kf, aK2 = aK * aK;
  const float at = atanf(as / Kf);
  const float s2 = as * as, s4 = s2 * s2;
  const float dK = Kf * Kf + s2;
  float t1, t2, t3;
  if (small) {
    t1 = (1.0f - aK2 / 3.0f + aK2 * aK2 / 5.0f) / Kf;
    t2 = 1.0f / (3.0f * Kf * Kf * Kf) - 2.0f * a2 / (5.0f * powf(Kf, 5))
         + 3.0f * a4 / (7.0f * powf(Kf, 7));
    t3 = 1.0f / (5.0f * powf(Kf, 5)) - 3.0f * a2 / (7.0f * powf(Kf, 7))
         + 2.0f * a4 / (3.0f * powf(Kf, 9));
  } else {
    t1 = at / as;
    t2 = at / (2.0f * (as * s2)) - Kf / (2.0f * s2 * dK);
    t3 = 3.0f * at / (8.0f * (as * s4)) - Kf / (4.0f * s2 * dK * dK)
         - 3.0f * Kf / (8.0f * s4 * dK);
  }
  const float dKa = Kf * Kf + a2;
  const float dKa2 = dKa * dKa;
  *S1 = t1 - (2.0f * Kf / 24.0f) / dKa2;
  *S2 = t2 - (4.0f * Kf / 24.0f) / (dKa2 * dKa);
  *S3 = t3 - (6.0f * Kf / 24.0f) / (dKa2 * dKa2);
}

// N(E[PG(b, c)], Var[PG(b, c)]) floored at 1e-30, with the moments of
// pyglm_tpu_torch/ops/polyagamma.py::pg_mean and pg_var.
__device__ float normal_approx(float b, float c, Philox* st) {
  const float x = 0.5f * fabsf(c);
  const float ratio = x < 1e-3f ? 1.0f - x * x / 3.0f + 2.0f * x * x * x * x / 15.0f
                                : tanhf(x) / x;
  const float m = 0.25f * b * ratio;
  const float ca = fabsf(c);
  float v;
  if (ca < 0.6f) {
    const float c2 = ca * ca;
    v = 1.0f / 24.0f - c2 / 120.0f + 17.0f * c2 * c2 / 13440.0f;
  } else {
    const float t = tanhf(0.5f * ca);
    v = (2.0f * t - ca * (1.0f - t * t)) / (4.0f * ca * ca * ca);
  }
  return fmaxf(m + sqrtf(b * v) * curand_normal(st), 1e-30f);
}

__device__ float gamma_series(float b, float c, Philox* st) {
  const float bp = fmaxf(b, 1e-6f);
  const float a = fabsf(c) / (2.0f * kPi);
  const float a2 = a * a;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    const float h = k + 0.5f;
    s += gamma_draw(bp, st) / (h * h + a2);
  }
  s /= 2.0f * kPi * kPi;
  float S1, S2, S3;
  tail_sums(a, &S1, &S2, &S3);
  const float tpp = 2.0f * kPi * kPi;
  const float m_t = bp * S1 / tpp;
  const float v_t = bp * S2 / (4.0f * kPi * kPi * kPi * kPi);
  const float mu3 = 2.0f * bp * S3 / (tpp * tpp * tpp);
  const float beta = 2.0f * v_t / fmaxf(mu3, 1e-30f);
  const float alpha = v_t * beta * beta;
  const float delta = fmaxf(m_t - alpha / beta, 0.0f);
  return s + delta + gamma_draw(alpha, st) / beta;
}

__global__ void pg_gamma_kernel(const float* __restrict__ b,
                                const float* __restrict__ c,
                                float* __restrict__ out, long long n,
                                float cutoff, unsigned long long seed,
                                unsigned long long offset) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float bi = b[i];
    if (!(bi >= cutoff) && !(bi > 0.0f)) {
      out[i] = 0.0f;
      continue;
    }
    Philox st;
    curand_init(seed, (unsigned long long)i, offset, &st);
    out[i] = bi >= cutoff ? normal_approx(bi, c[i], &st)
                          : gamma_series(bi, c[i], &st);
  }
}

}  // namespace

extern "C" int pg_gamma_series_launch(const float* b, const float* c,
                                      float* out, long long n, float cutoff,
                                      unsigned long long seed,
                                      unsigned long long offset,
                                      void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  pg_gamma_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      b, c, out, n, cutoff, seed, offset);
  return (int)cudaGetLastError();
}
