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
// kernel runs a fixed two Marsaglia-Tsang rounds per pair of terms and hands
// the ~2e-5 of elements whose budget ran out to the finisher. Here an
// element's proposals run until it has its draws: a thread has no
// stragglers. An element whose kMaxRounds pairs of proposals leave a draw
// short (probability below 1e-1000) keeps the mean of that Gamma.
//
// Regimes, chosen per element so each element is drawn once: b >= cutoff
// gives the normal approximation N(E, Var) floored at 1e-30 (cutoff 170 for
// the hybrid sampler, +inf for the plain series, -inf for "normal"); else
// b <= 0 gives 0; else the series with b+ = max(b, 1e-6).
//
// Bound on the H100: instruction issue and the warp's wait for its slowest
// lane, not memory: 2e7 elements move 240 MB (72 us at 3.35 TB/s). A
// lane's work is its Marsaglia-Tsang proposals, each a normal (a log, a
// sqrt and a sine and cosine per Box-Muller pair), a uniform and a Philox
// call per two, and the acceptance loop is a divergent branch: a warp runs
// it until its slowest lane has accepted. The design cuts both:
//   - the four series terms and the tail share one proposal stream: the
//     terms are Gamma(b+) of one shape, so one Marsaglia-Tsang loop runs
//     until four proposals are accepted and the k-th accepted value goes
//     to term k; the proposals after the fourth acceptance are tried at the
//     tail's shape alpha until one is accepted. The shape a proposal is
//     tried at and the term it goes to depend only on the acceptance
//     history, never on the values, so the terms stay independent draws of
//     their laws (pg_pallas.py:510-518 argues it for two terms). A warp
//     then waits once for its slowest lane, not five times;
//   - both normals of a Box-Muller pair are used, one per proposal, and
//     each Philox4x32-10 call's four words give two proposals (two normals,
//     two uniforms): no generator state in device memory, one call per two
//     proposals;
//   - squeezes decide before the two logs: Marsaglia-Tsang's u < 1 -
//     0.0331 x^4 and a tighter one for large shapes (mt_accept); both are
//     exact. Marsaglia-Tsang's alone leaves 8.3% of the proposals at shape
//     4 to the logs, so some lane of a warp nearly always takes them and
//     the warp with it; with both, 1.1%;
//   - d and 1/sqrt(9 d) once per shape and element, the tail's powers of
//     K = 4 as constants, reciprocals where the old code divided (but in
//     the tail sums' cancelling branch).

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979f;
constexpr int kTerms = 4;              // _GAMMA_K of the TPU kernel
constexpr float kK = (float)kTerms;
constexpr int kMaxRounds = 1000;       // pairs of proposals per element

// One Philox4x32-10 stream: key (seed), counter (offset, element); each
// call's four words are used at once.
struct Philox {
  uint4 ctr;
  uint2 key;
  __device__ Philox(unsigned long long seed, unsigned long long elem,
                    unsigned long long offset)
      : ctr(make_uint4((uint32_t)offset, (uint32_t)(offset >> 32),
                       (uint32_t)elem, (uint32_t)(elem >> 32))),
        key(make_uint2((uint32_t)seed, (uint32_t)(seed >> 32))) {}
  __device__ uint4 next() {
    const uint4 w = curand_Philox4x32_10(ctr, key);
    if (++ctr.x == 0) ++ctr.y;
    return w;
  }
};

// U(0, 1], as curand_uniform maps a word.
__device__ __forceinline__ float unif(uint32_t x) {
  return __uint2float_rn(x) * 2.3283064e-10f + 1.1641532e-10f;
}

// Two independent standard normals from one Box-Muller radius. The fast
// log and sine/cosine (absolute error 2^-21.4) move a normal by at most
// ~1e-3 within 1e-3 of 0 and by ~1e-6 relative elsewhere: invisible in the
// Gamma draws, and 12% of the kernel's time at the NB flagship (PERF.md).
__device__ __forceinline__ void normal_pair(uint32_t a, uint32_t b,
                                            float* x1, float* x2) {
  const float r = sqrtf(fmaxf(-2.0f * __logf(unif(a)), 0.0f));
  float s, c;
  __sincosf(kPi * (2.0f * unif(b) - 1.0f), &s, &c);   // angle in (-pi, pi]
  *x1 = r * c;
  *x2 = r * s;
}

// Marsaglia and Tsang's test of proposal normal x with uniform u for
// Gamma(d + 1/3), c = 1/sqrt(9 d): accept iff log u < x^2/2 + d (1 - v +
// log v), v = (1 + c x)^3; true, and *g = d v, on acceptance. Two exact
// squeezes accept before the logs, each a lower bound of the right side
// under log u <= u - 1: Marsaglia and Tsang's -0.0331 x^4 (shapes >= 1),
// and one that tightens with d. With y = c x the right side is 3 d R(y),
// R(y) = log(1 + y) - y + y^2/2 - y^3/3: for y >= 0, R(y) >= -y^4/4
// (Lagrange); for -1 < y < 0, R(y) = -sum_{k>=4} |y|^k / k >= -y^4 / (4 (1
// + y)). So the right side is at least -x^4 / (108 d min(1, v0)), v0 = 1 +
// y; `sq` is 1/(100 d), 8% inside that. At shape 4 the two leave 1.1% of
// the proposals to the logs (0.8% are rejected), against 8.3% for the
// first alone, so a warp of 32 lanes mostly skips them too.
__device__ __forceinline__ bool mt_accept(float x, float u, float d,
                                          float cm, float sq, float* g) {
  const float v0 = fmaf(cm, x, 1.0f);
  const float v = v0 * v0 * v0;
  *g = d * v;
  if (v0 <= 0.0f) return false;
  const float x2 = x * x, x4 = x2 * x2;
  const float m = fminf(v0, 1.0f);
  if (u * m < m - sq * x4 || u < 1.0f - 0.0331f * x4) return true;
  return logf(u) < 0.5f * x2 + d - d * v + d * logf(v);
}

// Sums over k > K of 1/d_k, 1/d_k^2, 1/d_k^3, d_k = (k - 1/2)^2 + a^2: the
// float32 formulas of pyglm_tpu/ops/polyagamma.py::_tail_sums (midpoint
// integrals, Taylor series below a = 0.5 where the exact S2/S3 cancel, and
// the first Euler-Maclaurin correction).
__device__ void tail_sums(float a, float* S1, float* S2, float* S3) {
  constexpr float kK3 = kK * kK * kK, kK5 = kK3 * kK * kK;
  constexpr float kK7 = kK5 * kK * kK, kK9 = kK7 * kK * kK;
  const float a2 = a * a, a4 = a2 * a2;
  const float i1 = 1.0f / (kK * kK + a2), i2 = i1 * i1;
  float t1, t2, t3;
  if (a < 0.5f) {
    const float aK2 = a2 * (1.0f / (kK * kK));
    t1 = (1.0f - aK2 * (1.0f / 3.0f) + aK2 * aK2 * (1.0f / 5.0f)) *
         (1.0f / kK);
    t2 = 1.0f / (3.0f * kK3) - a2 * (2.0f / (5.0f * kK5)) +
         a4 * (3.0f / (7.0f * kK7));
    t3 = 1.0f / (5.0f * kK5) - a2 * (3.0f / (7.0f * kK7)) +
         a4 * (2.0f / (3.0f * kK9));
  } else {
    // Divisions as in the plain version: S3 cancels by ~1e4 near a = 0.5,
    // and reciprocals there double its rounding error.
    const float at = atanf(a / kK);
    const float s2 = a2, s4 = a4, dK = kK * kK + s2;
    t1 = at / a;
    t2 = at / (2.0f * (a * s2)) - kK / (2.0f * s2 * dK);
    t3 = 3.0f * at / (8.0f * (a * s4)) - kK / (4.0f * s2 * dK * dK) -
         3.0f * kK / (8.0f * s4 * dK);
  }
  *S1 = t1 - (2.0f * kK / 24.0f) * i2;
  *S2 = t2 - (4.0f * kK / 24.0f) * (i2 * i1);
  *S3 = t3 - (6.0f * kK / 24.0f) * (i2 * i2);
}

// N(E[PG(b, c)], Var[PG(b, c)]) floored at 1e-30, with the moments of
// pyglm_tpu_torch/ops/polyagamma.py::pg_mean and pg_var.
__device__ float normal_approx(float b, float c, Philox& rng) {
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
  const uint4 wd = rng.next();
  float z, z2;
  normal_pair(wd.x, wd.y, &z, &z2);
  return fmaxf(m + sqrtf(b * v) * z, 1e-30f);
}

// Marsaglia-Tsang's constants for Gamma(shape): d = shape' - 1/3,
// 1/sqrt(9 d) and the squeeze's 1/(100 d), with shape' = shape + 1 below
// 1, where the draw is boosted by U^(1/shape) after (it underflows to 0 in
// float32 for tiny shapes, as the true Gamma(shape) mass near 0 does).
struct MTShape {
  float d, cm, sq;
  bool boost;
};

__device__ __forceinline__ MTShape mt_shape(float shape) {
  const bool boost = shape < 1.0f;
  const float d = (boost ? shape + 1.0f : shape) - 1.0f / 3.0f;
  return {d, rsqrtf(9.0f * d), 0.01f / d, boost};
}

__device__ float gamma_series(float b, float c, Philox& rng) {
  const float bp = fmaxf(b, 1e-6f);
  const float a = fabsf(c) * (0.5f / kPi);
  const float a2 = a * a;
  float S1, S2, S3;
  tail_sums(a, &S1, &S2, &S3);
  constexpr float tpp = 2.0f * kPi * kPi;
  const float m_t = bp * S1 * (1.0f / tpp);
  const float v_t = bp * S2 * (1.0f / (4.0f * kPi * kPi * kPi * kPi));
  const float mu3 = 2.0f * bp * S3 * (1.0f / (tpp * tpp * tpp));
  const float beta = 2.0f * v_t / fmaxf(mu3, 1e-30f);
  const float alpha = v_t * beta * beta;
  const float ib = 1.0f / beta;
  const float delta = fmaxf(m_t - alpha * ib, 0.0f);
  const MTShape ser = mt_shape(bp), tail = mt_shape(alpha);
  // The weights 1/((k - 1/2)^2 + a^2) of the terms still to come, next first.
  float w0 = 1.0f / (0.25f + a2), w1 = 1.0f / (2.25f + a2);
  float w2 = 1.0f / (6.25f + a2), w3 = 1.0f / (12.25f + a2);
  uint4 bw = ser.boost ? rng.next() : make_uint4(0, 0, 0, 0);  // boosts
  float s = 0.0f, g_tail = tail.d + 1.0f / 3.0f;
  int n = 0;                   // accepted: series terms 0..3, then the tail
  auto take = [&](float g) {
    if (ser.boost) {
      g *= expf(logf(unif(bw.x)) / bp);
      bw = make_uint4(bw.y, bw.z, bw.w, 0);
    }
    s += g * w0;
    w0 = w1;
    w1 = w2;
    w2 = w3;
    ++n;
  };
  // One proposal stream: the first kTerms accepted at the series' shape go
  // to the terms in order, the next, tried at the tail's shape, is the tail.
  auto propose = [&](float x, float u) {
    if (n > kTerms) return;
    const bool t = n == kTerms;
    float v;
    if (!mt_accept(x, u, t ? tail.d : ser.d, t ? tail.cm : ser.cm,
                   t ? tail.sq : ser.sq, &v))
      return;
    if (t) {
      g_tail = v;
      ++n;
    } else {
      take(v);
    }
  };
  for (int r = 0; r < kMaxRounds && n <= kTerms; ++r) {
    const uint4 wd = rng.next();
    float x1, x2;
    normal_pair(wd.x, wd.y, &x1, &x2);
    propose(x1, unif(wd.z));
    propose(x2, unif(wd.w));
  }
  while (n < kTerms) take(ser.d + 1.0f / 3.0f);
  if (tail.boost) g_tail *= expf(logf(unif(rng.next().x)) / alpha);
  return s * (1.0f / tpp) + delta + g_tail * ib;
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
    Philox rng(seed, (unsigned long long)i, offset);
    out[i] = bi >= cutoff ? normal_approx(bi, c[i], rng)
                          : gamma_series(bi, c[i], rng);
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
