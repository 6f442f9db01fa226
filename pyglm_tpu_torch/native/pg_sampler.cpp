// Exact Polya-Gamma PG(1, c) sampler — native C++/OpenMP implementation.
//
// Role in pyglm_tpu: the reference's native layer is a C++ PG sampler
// (pypolyagamma/cpp/PolyaGamma.cpp, OpenMP fan-out in pgdrawvpar). The TPU
// compute path replaces it with Pallas/XLA kernels (ops/pg_pallas.py,
// ops/polyagamma.py); THIS file is the host-side native equivalent, written
// from the Polson–Scott–Windle (2013) / Devroye algorithm:
//   * an independent oracle for statistical cross-checks of the TPU
//     samplers (different code, different RNG, same distribution), and
//   * a fast multi-threaded CPU path for the compat layer.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC pg_sampler.cpp -o libpg.so
#include <cmath>
#include <cstdint>
#include <random>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kT = 0.64;           // proposal truncation point
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kLogSqrt2Pi = 0.9189385332046727;

// log Phi(x), stable in the deep left tail.
double log_norm_cdf(double x) {
  if (x > -30.0) return std::log(0.5 * std::erfc(-x / kSqrt2));
  // asymptotic: Phi(x) ~ phi(x)/|x| * (1 - 1/x^2)
  return -0.5 * x * x - kLogSqrt2Pi - std::log(-x) + std::log1p(-1.0 / (x * x));
}

// a_n(x): alternating-series coefficients for J*(1, .).
double coef(double x, int n) {
  const double half = n + 0.5;
  if (x <= kT) {
    return M_PI * half * std::pow(2.0 / (M_PI * x), 1.5) *
           std::exp(-2.0 * half * half / x);
  }
  return M_PI * half * std::exp(-half * half * M_PI * M_PI * x / 2.0);
}

struct Rng {
  std::mt19937_64 gen;
  std::uniform_real_distribution<double> unif{0.0, 1.0};
  std::exponential_distribution<double> expo{1.0};
  std::normal_distribution<double> norm{0.0, 1.0};
  explicit Rng(uint64_t seed) : gen(seed) {}
  double u() { return unif(gen); }
  double e() { return expo(gen); }
  double n() { return norm(gen); }
};

// X ~ InverseGaussian(1/z, 1) truncated to (0, t).
double trunc_inv_gauss(Rng &r, double z) {
  if (z * kT < 1.0) {             // mu > t: tilted-Levy rejection
    for (;;) {
      double e1, e2;
      do {
        e1 = r.e();
        e2 = r.e();
      } while (e1 * e1 > 2.0 * e2 / kT);
      const double x = kT / ((1.0 + kT * e1) * (1.0 + kT * e1));
      if (r.u() <= std::exp(-0.5 * z * z * x)) return x;
    }
  }
  const double mu = 1.0 / z;       // mu <= t: Michael–Schucany–Haas
  for (;;) {
    const double nrm = r.n();      // one normal, squared (chi^2_1)
    const double y = nrm * nrm;
    const double muy = mu * y;
    double x = mu + 0.5 * mu * muy -
               0.5 * mu * std::sqrt(4.0 * muy + muy * muy);
    if (x <= 0.0) x = mu * 1e-14;
    if (r.u() > mu / (mu + x)) x = mu * mu / x;
    if (x <= kT) return x;
  }
}

// One exact PG(1, c) draw (PSW 2013 Algorithm 1; returns J*(1, |c|/2)/4).
double pg_draw_one(Rng &r, double c) {
  const double z = 0.5 * std::fabs(c);
  const double K = M_PI * M_PI / 8.0 + 0.5 * z * z;
  const double logp = std::log(M_PI / (2.0 * K)) - K * kT;
  const double sqt = std::sqrt(kT);
  const double logq =
      std::log(2.0) +
      std::log(std::exp(-z + log_norm_cdf((z * kT - 1.0) / sqt)) +
               std::exp(z + log_norm_cdf(-(z * kT + 1.0) / sqt)));
  const double ratio = 1.0 / (1.0 + std::exp(logq - logp));   // p/(p+q)

  for (;;) {
    double x;
    if (r.u() < ratio) {
      x = kT + r.e() / K;
    } else {
      x = trunc_inv_gauss(r, z);
    }
    double s = coef(x, 0);
    const double y = r.u() * s;
    for (int n = 1;; ++n) {
      const double t = coef(x, n);
      if (n & 1) {
        s -= t;
        if (y <= s) return 0.25 * x;
      } else {
        s += t;
        if (y > s) break;       // reject; new proposal
      }
    }
  }
}

}  // namespace

extern "C" {

// Fill out[0..n) with PG(1, c[i]) draws using n_threads OpenMP threads,
// one independent counter-seeded RNG stream per thread.
void pg_devroye_vec(const double *c, double *out, int64_t n, uint64_t seed,
                    int n_threads) {
#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
  {
    const int tid = omp_get_thread_num();
    Rng r(seed * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL * (tid + 1));
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) out[i] = pg_draw_one(r, c[i]);
  }
#else
  Rng r(seed);
  for (int64_t i = 0; i < n; ++i) out[i] = pg_draw_one(r, c[i]);
#endif
}

// PG(b, c) for integer b via b-fold convolution of PG(1, c).
void pg_int_b_vec(const double *b, const double *c, double *out, int64_t n,
                  uint64_t seed, int n_threads) {
#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
  {
    const int tid = omp_get_thread_num();
    Rng r(seed * 0x9E3779B97F4A7C15ULL + 0xA0761D6478BD642FULL * (tid + 1));
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      const int bi = static_cast<int>(b[i]);
      for (int k = 0; k < bi; ++k) acc += pg_draw_one(r, c[i]);
      out[i] = acc;
    }
  }
#else
  Rng r(seed);
  for (int64_t i = 0; i < n; ++i) {
    double acc = 0.0;
    const int bi = static_cast<int>(b[i]);
    for (int k = 0; k < bi; ++k) acc += pg_draw_one(r, c[i]);
    out[i] = acc;
  }
#endif
}

}  // extern "C"
