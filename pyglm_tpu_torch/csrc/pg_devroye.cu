// K1: exact Polya-Gamma PG(1, c) draws by Devroye's alternating-series
// rejection sampler; each lane of a warp draws elements of the warp's chunk
// one after another.
//
// Replaces the TPU kernel pyglm_tpu/ops/pg_pallas.py::_pg_kernel (launched
// by _kernel_pass from pg_devroye_pallas) together with its straggler
// finisher (_finish_by_extraction + _pg_draw_small). The TPU kernel runs a
// fixed two proposal rounds per element and hands the ~1e-5 that fail to a
// compacting finisher. Here each element is drawn until it accepts; after
// kMaxRounds rounds (probability below 1e-300) it keeps the conditional
// mean tanh(z)/z.
//
// Bound on the H100: instruction issue, not memory. 20M elements move 160
// MB (48 us at 3.35 TB/s) while every element forms its mixture weight
// (two erfc-family calls and an exp) and runs at least one proposal with
// its transcendentals, and the lanes of a warp take different branches
// (exponential tail, tilted Levy, Michael-Schucany-Haas), so a warp runs
// each branch that one of its lanes takes. The inverse-Gaussian branch
// takes most of the time (PERF.md: with every proposal from the tail the
// kernel runs in a quarter of it): a lane needs ~1.3 proposal steps, but a
// warp that waits each round for its slowest lane runs ~4 tries of both
// inverse-Gaussian kinds. So a lane whose element accepts takes the next
// element of its warp's chunk at once, and the chunk is served Levy
// elements first, MSH ones after. The design keeps all state in registers,
// reads and writes each element once, and cuts the work per element:
//   - the mixture weight in fp32 (mixture_weight below, the formula of
//     ops/polyagamma.py::mixture_weight): no f64, no log, one exp, erfcf
//     and erfcxf;
//   - the Levy branch's two tests merged into one (E2 marginalised, as the
//     TPU kernel does): one log and one exp per try;
//   - the Michael-Schucany-Haas chi^2_1 variates drawn in pairs from one
//     Box-Muller radius (R^2 cos^2, R^2 sin^2 are independent chi^2_1);
//   - the first series test U <= 1 - a_1/a_0 with a_1/a_0 = 3 exp(-4/x)
//     (x <= t) or 3 exp(-pi^2 x): one exp, no log; the exact alternating
//     loop runs only in the band S_1 < U <= S_2 (mass below 4e-8), so the
//     law stays exact (the TPU kernel stops after the first term);
//   - a counter-based Philox4x32-10 stream per element whose four words
//     per call are all used, with no generator state in device memory.
// Exhausting kMaxRounds truncated-inverse-Gaussian tries counts as a
// rejected outer round, which leaves the law exact.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kT = 0.64f;            // proposal truncation point t
constexpr float kPi = 3.14159265358979f;
constexpr int kMaxRounds = 1000;
constexpr int kMaxSeries = 64;
// Constants of the mixture weight (ops/polyagamma.py): t/2 and pi^2 t / 8
// as float32 plus their rounding errors, e^{pi^2 t/8 - 1/(2t)}, 1/sqrt(t).
constexpr float kHalfT = 0.32f;
constexpr float kHalfTLo = 7.152557373046875e-09f;
constexpr float kC1 = 0.78956835f;
constexpr float kC1Lo = -1.2533060e-08f;
constexpr float kC2 = 1.0083530f;
constexpr float kRsqrtT = 1.25f;
constexpr float kRsqrt2 = 0.70710678f;

// One Philox4x32-10 stream: key (seed), counter (block, element); each
// call's four words are handed out in turn.
struct Philox {
  uint4 ctr, w;
  uint2 key;
  int left;
  __device__ Philox(unsigned long long seed, unsigned long long elem,
                    unsigned long long offset)
      : ctr(make_uint4((uint32_t)offset, (uint32_t)(offset >> 32),
                       (uint32_t)elem, (uint32_t)(elem >> 32))),
        w(make_uint4(0, 0, 0, 0)),
        key(make_uint2((uint32_t)seed, (uint32_t)(seed >> 32))),
        left(0) {}
  // U(0, 1], as curand_uniform maps a word.
  __device__ float uniform() {
    if (left == 0) {
      w = curand_Philox4x32_10(ctr, key);
      if (++ctr.x == 0) ++ctr.y;
      left = 4;
    }
    const uint32_t x = w.x;
    w = make_uint4(w.y, w.z, w.w, 0);
    --left;
    return __uint2float_rn(x) * 2.3283064e-10f + 1.1641532e-10f;
  }
};

// fl(a + b) and its rounding error (Knuth's TwoSum).
__device__ __forceinline__ float two_sum(float a, float b, float* e) {
  const float s = __fadd_rn(a, b), bb = __fsub_rn(s, a);
  *e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// p / (p + q), the weight of the exponential branch, in fp32: the formula
// and its error analysis are ops/polyagamma.py::mixture_weight's.
__device__ float mixture_weight(float z) {
  const float zz = __fmul_rn(z, z), zz_e = fmaf(z, z, -zz);
  const float s = __fmul_rn(zz, kHalfT);
  const float s_e = fmaf(zz, kHalfT, -s) + (zz * kHalfTLo + zz_e * kHalfT);
  float d_e, e_e;
  const float d = two_sum(kC1, -z, &d_e);
  const float e = two_sum(s, d, &e_e);
  e_e = e_e + (s_e + (d_e + kC1Lo));
  const float a = (z * kT - 1.0f) * kRsqrtT;
  const float b = (z * kT + 1.0f) * kRsqrtT;
  const float phi = a < 0.0f ? 0.5f * erfcf(-a * kRsqrt2)
                             : 1.0f - 0.5f * erfcf(a * kRsqrt2);
  const float K = kPi * kPi / 8.0f + 0.5f * zz;
  const float r = (2.0f / kPi) * K *
                  (2.0f * phi * (expf(e) * (1.0f + e_e)) +
                   kC2 * erfcxf(b * kRsqrt2));
  return 1.0f / (1.0f + r);
}

// One try of a proposal from the truncated inverse Gaussian IG(1/z, 1) on
// (0, t); true and *out on acceptance. `chi` carries the second chi^2_1 of
// a Box-Muller pair to the next try (< 0: none).
__device__ bool ig_try(float z, bool levy, float mu, Philox& rng, float& chi,
                       float* out) {
  if (levy) {
    // Tilted Levy: X = t/(1 + t E1)^2, accepted w.p.
    // P(E2 >= t E1^2/2) e^{-z^2 X/2} = e^{-(t E1^2 + z^2 X)/2}.
    const float e1 = -logf(rng.uniform());
    const float d = 1.0f + kT * e1;
    *out = kT / (d * d);
    return rng.uniform() <= expf(-0.5f * (kT * e1 * e1 + z * z * *out));
  }
  // Michael-Schucany-Haas, retried until X <= t.
  float y = chi;
  if (y < 0.0f) {
    const float r2 = -2.0f * logf(rng.uniform());
    float sn, cs;
    sincospif(2.0f * rng.uniform(), &sn, &cs);
    y = r2 * cs * cs;
    chi = r2 * sn * sn;
  } else {
    chi = -1.0f;
  }
  const float muy = mu * y;
  float x = mu + 0.5f * mu * muy -
            0.5f * mu * sqrtf(4.0f * muy + muy * muy);
  x = fmaxf(x, 1e-30f);
  if (rng.uniform() > mu / (mu + x)) x = fminf(mu * mu / x, 1e30f);
  *out = x;
  return x <= kT;
}

// The alternating-series test of proposal x with U = u: accept iff u <=
// S_n / a_0 at the first odd n where that holds, reject at the first even
// n with u > S_n / a_0. a_n / a_0 = (2n + 1) exp(n (n + 1) w / 2) with
// w = -4/x (x <= t) or -pi^2 x.
__device__ bool series_accept(float x, float u) {
  const float w1 = x <= kT ? -4.0f / x : -kPi * kPi * x;
  const float a1 = 3.0f * expf(w1);
  float s = 1.0f - a1;
  if (u <= s) return true;
  for (int n = 2; n <= kMaxSeries; ++n) {
    const float term = (2 * n + 1) * expf(0.5f * (float)(n * (n + 1)) * w1);
    if (n & 1) {
      s -= term;
      if (u <= s) return true;
    } else {
      s += term;
      if (u > s) return false;
    }
  }
  return false;
}

// Each warp draws a chunk of 32 kPerLane consecutive elements. It first
// orders the chunk by proposal kind: the elements whose inverse-Gaussian
// proposal is the tilted Levy one (z t < 1) first, the Michael-Schucany-
// Haas ones after them, so the lanes of a warp mostly run one kind's code.
// A lane takes one step per iteration of the warp's loop: a new round's
// branch draw with its exponential-tail proposal, or one inverse-Gaussian
// try, and then the series test of a proposal that came out. A lane whose
// element accepts (or exhausts kMaxRounds rounds) writes it and takes the
// next element in that order at the next iteration, so the warp's lanes
// stay busy until the chunk runs dry, instead of waiting each round for
// the slowest lane's tries. Each element draws from its own Philox stream,
// so its draw does not depend on the lane or the order that serve it.
// Of 16, 32 and 64 elements a lane, 32 ran fastest at the flagship's shape
// and beat 16 at config 5's, with the same draws (PERF.md).
constexpr int kPerLane = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pg_devroye_kernel(const float* __restrict__ c, float* __restrict__ out,
                  long long n, unsigned long long seed,
                  unsigned long long offset) {
  __shared__ uint16_t order[kThreads / 32][32 * kPerLane];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const long long start =
      ((blockIdx.x * (long long)kThreads + threadIdx.x) >> 5) * 32 * kPerLane;
  const int cnt = (int)max(0LL, min(n - start, 32LL * kPerLane));
  uint16_t* ord = order[threadIdx.x >> 5];
  // Levy elements from the front of `ord`, MSH ones from the back.
  int n_levy = 0, n_msh = 0;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int o = 32 * j + lane;
    const bool valid = o < cnt;
    const bool lv = valid && 0.5f * fabsf(c[start + o]) * kT < 1.0f;
    const unsigned bl = __ballot_sync(0xffffffffu, lv);
    const unsigned bm = __ballot_sync(0xffffffffu, valid && !lv);
    if (lv) ord[n_levy + __popc(bl & below)] = (uint16_t)o;
    if (valid && !lv) ord[cnt - 1 - n_msh - __popc(bm & below)] = (uint16_t)o;
    n_levy += __popc(bl);
    n_msh += __popc(bm);
  }
  __syncwarp();

  Philox rng(seed, 0, offset);
  long long i = 0;
  int next = 0;
  float z = 0.0f, ratio_exp = 0.0f, K = 0.0f, mu = 0.0f, chi = -1.0f;
  bool levy = false, tail = false, fresh = false, active = false;
  int rounds = 0, tries = 0;
  for (;;) {
    const unsigned idle = __ballot_sync(0xffffffffu, !active);
    if (!active) {
      const int pos = next + __popc(idle & below);
      if (pos < cnt) {
        i = start + ord[pos];
        rng = Philox(seed, (unsigned long long)i, offset);
        z = 0.5f * fabsf(c[i]);
        ratio_exp = mixture_weight(z);
        K = kPi * kPi / 8.0f + 0.5f * z * z;
        levy = z * kT < 1.0f;
        mu = 1.0f / fmaxf(z, 1e-30f);
        chi = -1.0f;
        rounds = 0;
        fresh = active = true;
      }
    }
    next += __popc(idle);
    if (!__any_sync(0xffffffffu, active)) break;
    if (!active) continue;
    if (fresh) {
      const float u0 = rng.uniform();
      tail = u0 <= ratio_exp;
      fresh = false;
      tries = 0;
    }
    float x;
    bool have = true;
    if (tail) {
      x = kT - logf(rng.uniform()) / K;
    } else {
      have = ig_try(z, levy, mu, rng, chi, &x);
      // kMaxRounds failed tries reject the round.
      fresh = !have && ++tries == kMaxRounds;
    }
    if (have) {
      if (series_accept(fmaxf(x, 1e-30f), rng.uniform())) {
        out[i] = 0.25f * x;
        active = false;
        continue;
      }
      fresh = true;
    }
    if (fresh && ++rounds == kMaxRounds) {
      const float zs = fmaxf(z, 1e-6f);                 // fallback: E[J*]
      out[i] = 0.25f * (z < 1e-6f ? 1.0f : tanhf(zs) / zs);
      active = false;
    }
  }
}

}  // namespace

extern "C" int pg_devroye_launch(const float* c, float* out, long long n,
                                 unsigned long long seed,
                                 unsigned long long offset, void* stream) {
  if (n <= 0) return 0;
  const long long per_block = kThreads * (long long)kPerLane;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pg_devroye_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      c, out, n, seed, offset);
  return (int)cudaGetLastError();
}

extern "C" const char* pgt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
