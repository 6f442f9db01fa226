// K7: the latent-distance prior's HMC move, every trajectory of every chain
// in one launch. Per chain c, with positions L (N, dim), offset gamma and
// adjacency A (N, N) of 0s and 1s, lrho_ij = gamma - |l_i - l_j|^2 and
//   U      = -sum_ij (A_ij lrho_ij - softplus(lrho_ij))
//            + |L|^2 / (2 sigma_l^2) + gamma^2 / (2 sigma_gamma^2)
//   dU/dl_k = 2 sum_j (2 sigmoid(lrho_kj) - S_kj) (l_j - l_k) + l_k / sigma_l^2
//   dU/dgamma = sum_ij (sigmoid(lrho_ij) - A_ij) + gamma / sigma_gamma^2
// with S = A + A^T (the sums run over all i, j, i = j included: those terms
// enter U and dU/dgamma, not dU/dL). It runs `iters` trajectories of `steps`
// merged-kick leapfrog steps from the momenta mom_L[c, t], mom_gamma[c, t],
// each ended by the test log u[c, t] < U + K0 - Un - K1, and carries U and
// the gradient from one trajectory to the next: the arithmetic of
// models/networks.py::LatentDistanceConfig._hmc_plain, its plain version.
//
// Replaces no Pallas kernel: the JAX package runs this loop as a lax.scan
// of trajectories over a lax.scan of leapfrog steps, which XLA fuses
// (pyglm_tpu/models/networks.py:492-528). Run as PyTorch ops, a config-5
// move (C = 8, N = 500, 10 x 50) issues ~12,700 launches, each a pass over
// a (C, N, N) intermediate, and the host's launch rate sets the pace.
//
// Bound on the H100: the special-function unit. A gradient takes one exp
// and one reciprocal for each of C N^2 ordered pairs (C = 8, N = 500: 2e6),
// 500 gradients and 11 potentials a move: ~2e9 results at 4.18e12/s, 0.5 ms
// (0.25 ms over unordered pairs), and about as long in fp32 work. What
// paces the kernel is the chain of dependent steps: each leapfrog step
// needs every position of the step before. On the H100 a config-5 move
// takes 5.68 ms (PERF.md, section 6): 23x the bound over unordered pairs,
// with twice its pairs and 521 cluster barriers one after another.
//
// The design. One thread-block cluster per chain (blockIdx.y) of `cluster`
// CTAs (ops/ld_hmc_cuda.py::ld_hmc_plan: 8 at N > 256), each owning `rows`
// consecutive rows k. A chain's state lives on chip for the whole launch:
//   - each CTA keeps its rows' L, gradient, proposal, momenta and the
//     proposal's gradient in shared memory, and the whole chain's positions
//     twice (the step's and the next), in shared memory, or at large N dim
//     in a global scratch read through L2 (kPosGlobal);
//   - the rows' S = A + A^T as bytes, formed once at the start from A's rows
//     (coalesced) and columns (coalesced across rows), in shared memory or
//     at large N in a global scratch of its own (exact: A is 0/1).
// A warp takes a row k, its lanes the columns j, and reduces the row's
// gradient over the warp. After each kick, a CTA drifts its own rows and
// writes them into every CTA's next position buffer (distributed shared
// memory), together with its partial sum of dU/dgamma; one cluster barrier
// per leapfrog step then makes both visible, so a step costs one barrier.
// Every CTA sums the partials in the same order, in double, and so holds the
// same gamma, momenta, energies and accept decision. U, K0 and K1 are
// accumulated in double (each pair's term in fp32); the gradient's terms in
// fp32 with IEEE expf and division, as torch.sigmoid; softplus as
// max(x, 0) + log1p(exp(-|x|)), torch.logaddexp(x, 0)'s form. Nothing goes
// back to the host inside the launch; the accept counts come out per chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
// Shared-memory layout (bytes; ops/ld_hmc_cuda.py::ld_hmc_plan sums the
// same): the cluster's partial sums [2 buffers][kMaxCluster ranks][2], the
// warps' [kWarps][2], then the own rows' five arrays, then the two position
// buffers and the S rows where they are on chip, each part 16-byte aligned.
constexpr int kRedBytes = 2 * kMaxCluster * 2 * 8;
constexpr int kWarpBytes = kWarps * 2 * 8;

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) / 16 * 16;
}

struct Params {
  const float* L;       // (C, N, dim)
  const float* gamma;   // (C,)
  const float* A;       // (C, N, N)
  const float* mom_L;   // (C, iters, N, dim)
  const float* mom_g;   // (C, iters)
  const float* u;       // (C, iters)
  float* L_out;         // (C, N, dim)
  float* gamma_out;     // (C,)
  int* count;           // (C,)
  float* pos_g;         // (C, 2, N, dim) where the positions are not on chip
  uint8_t* slab_g;      // (C, N, N) where the S rows are not on chip
  int N, iters, steps, rows, slab_in_smem;
  float eps, half_eps, inv_sl2, inv_sg2;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Row j of a position buffer: DIM floats, 16- or 8-byte loads where DIM
// allows; from L2 (cg) where the buffer is in global memory, since other
// SMs write it.
template <int DIM, bool kPosGlobal>
__device__ __forceinline__ void load_row(const float* p, float (&v)[DIM]) {
  if constexpr (DIM % 4 == 0) {
#pragma unroll
    for (int q = 0; q < DIM / 4; ++q) {
      const float4 t = kPosGlobal ? __ldcg(reinterpret_cast<const float4*>(p) + q)
                                  : reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
  } else if constexpr (DIM % 2 == 0) {
#pragma unroll
    for (int q = 0; q < DIM / 2; ++q) {
      const float2 t = kPosGlobal ? __ldcg(reinterpret_cast<const float2*>(p) + q)
                                  : reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x; v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < DIM; ++q) v[q] = kPosGlobal ? __ldcg(p + q) : p[q];
  }
}

template <int DIM, bool kPosGlobal>
struct Chain {
  Params p;
  cg::cluster_group cluster;
  int c, rank, K, row0, rows;
  double* red;      // [2][kMaxCluster][2], this CTA's copy
  double* wpart;    // [kWarps][2]
  float *Lo, *gLo, *Ln, *mL, *gLn;   // own rows, (rows, DIM) each
  float *pos0, *pos1;                // whole chain, (N, DIM) each
  const uint8_t* slab;               // own rows of S, (rows, N)
  int rb = 0;       // the partial-sum buffer the next reduction writes

  __device__ float* pos(int b) const { return b ? pos1 : pos0; }

  __device__ void sync() {
    if constexpr (kPosGlobal) __threadfence();
    cluster.sync();
  }

  // Write own element e (row row0 + e / DIM) of the next positions into
  // buffer b of every CTA of the cluster.
  __device__ void publish(int b, int e, float v) {
    const int at = row0 * DIM + e;
    if constexpr (kPosGlobal) {
      pos(b)[at] = v;
    } else {
      float* dst = pos(b);
      for (int r = 0; r < K; ++r) cluster.map_shared_rank(dst, r)[at] = v;
    }
  }

  // Sum (a, b) over the CTA's threads and hand the CTA's sums to every CTA
  // of the cluster; then one barrier, and every thread reads the cluster's
  // sums, in rank order (the same doubles in every CTA).
  __device__ double2 reduce(double a, double b) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      wpart[2 * warp] = a;
      wpart[2 * warp + 1] = b;
    }
    __syncthreads();
    if (threadIdx.x < K) {
      double sa = 0.0, sb = 0.0;
      for (int w = 0; w < kWarps; ++w) {
        sa += wpart[2 * w];
        sb += wpart[2 * w + 1];
      }
      double* dst = cluster.map_shared_rank(red, (int)threadIdx.x) +
                    (rb * kMaxCluster + rank) * 2;
      dst[0] = sa;
      dst[1] = sb;
    }
    sync();
    double sa = 0.0, sb = 0.0;
    for (int r = 0; r < K; ++r) {
      sa += red[(rb * kMaxCluster + r) * 2];
      sb += red[(rb * kMaxCluster + r) * 2 + 1];
    }
    rb ^= 1;
    return make_double2(sa, sb);
  }

  // One pass over the own rows' pairs (k, j), all j, at positions `P` and
  // offset g: with kGrad the rows' gradient into gLn and, returned in .x,
  // this thread's share of sum (sigmoid - S / 2); with kU, in .y, its share
  // of U less the gamma prior. Only each warp's lane 0 returns nonzero sums.
  template <bool kGrad, bool kU>
  __device__ double2 pairs(const float* P, float g, float* grad_out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int N = p.N;
    double acc_g = 0.0, acc_u = 0.0;
    for (int kl = warp; kl < rows; kl += kWarps) {
      float lk[DIM];
      load_row<DIM, kPosGlobal>(P + (row0 + kl) * DIM, lk);
      const uint8_t* srow = slab + (size_t)kl * N;
      float gr[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) gr[d] = 0.f;
      float gs = 0.f;
      double uu = 0.0;
#pragma unroll 4
      for (int j = lane; j < N; j += 32) {
        float lj[DIM];
        load_row<DIM, kPosGlobal>(P + j * DIM, lj);
        const float s = (float)srow[j];
        float dx[DIM], d2 = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          dx[d] = lj[d] - lk[d];
          d2 = fmaf(dx[d], dx[d], d2);
        }
        const float lr = g - d2;
        if constexpr (kGrad) {
          const float sg = 1.f / (1.f + expf(-lr));
          const float cw = fmaf(2.f, sg, -s);
#pragma unroll
          for (int d = 0; d < DIM; ++d) gr[d] = fmaf(cw, dx[d], gr[d]);
          gs += fmaf(-0.5f, s, sg);
        }
        if constexpr (kU) {
          const float sp = fmaxf(lr, 0.f) + log1pf(expf(-fabsf(lr)));
          uu += (double)fmaf(0.5f * s, lr, -sp);
        }
      }
      if constexpr (kGrad) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) gr[d] = warp_sum(gr[d]);
        gs = warp_sum(gs);
      }
      if constexpr (kU) uu = warp_sum(uu);
      if (lane == 0) {
        if constexpr (kGrad) {
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            grad_out[kl * DIM + d] = fmaf(2.f, gr[d], lk[d] * p.inv_sl2);
          acc_g += (double)gs;
        }
        if constexpr (kU) {
          float l2 = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) l2 = fmaf(lk[d], lk[d], l2);
          acc_u += 0.5 * (double)l2 * (double)p.inv_sl2 - uu;
        }
      }
    }
    return make_double2(acc_g, acc_u);
  }
};

template <int DIM, bool kPosGlobal>
__global__ void __launch_bounds__(kThreads)
    ld_hmc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.y, tid = threadIdx.x;
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int N = p.N;
  const int row0 = min(rank * p.rows, N);
  const int rows = min(p.rows, N - row0);
  const int own = rows * DIM;

  Chain<DIM, kPosGlobal> ch{p, cluster, c, rank, K, row0, rows};
  ch.red = reinterpret_cast<double*>(smem);
  ch.wpart = reinterpret_cast<double*>(smem + kRedBytes);
  float* f = reinterpret_cast<float*>(smem + kRedBytes + kWarpBytes);
  const long long own_n = (long long)p.rows * DIM;
  ch.Lo = f;
  ch.gLo = f + own_n;
  ch.Ln = f + 2 * own_n;
  ch.mL = f + 3 * own_n;
  ch.gLn = f + 4 * own_n;
  unsigned char* tail =
      smem + kRedBytes + kWarpBytes + align16(5 * own_n * 4);
  const long long pos_n = (long long)N * DIM, pos_b = align16(pos_n * 4);
  if constexpr (kPosGlobal) {
    ch.pos0 = p.pos_g + (size_t)c * 2 * pos_n;
    ch.pos1 = ch.pos0 + pos_n;
  } else {
    ch.pos0 = reinterpret_cast<float*>(tail);
    ch.pos1 = reinterpret_cast<float*>(tail + pos_b);
    tail += 2 * pos_b;
  }
  uint8_t* slab = p.slab_in_smem
                      ? reinterpret_cast<uint8_t*>(tail)
                      : p.slab_g + ((size_t)c * N + row0) * N;
  ch.slab = slab;

  // S rows: A's rows, then A's columns added (each read coalesced).
  const float* Ac = p.A + (size_t)c * N * N;
  for (int i = tid; i < rows * N; i += kThreads) {
    const int kl = i / N, j = i - kl * N;
    slab[(size_t)kl * N + j] = (uint8_t)Ac[(size_t)(row0 + kl) * N + j];
  }
  __syncthreads();
  for (int i = tid; i < rows * N; i += kThreads) {
    const int j = i / rows, kl = i - j * rows;
    slab[(size_t)kl * N + j] += (uint8_t)Ac[(size_t)j * N + row0 + kl];
  }
  // The start: own rows of L, published into position buffer 0, once every
  // CTA of the cluster runs (a CTA's shared memory exists from its start).
  cluster.sync();
  const float* Lc = p.L + (size_t)c * pos_n;
  for (int e = tid; e < own; e += kThreads) {
    const float v = Lc[row0 * DIM + e];
    ch.Lo[e] = v;
    ch.publish(0, e, v);
  }
  ch.sync();
  int pb = 0;   // the buffer holding the positions of the last evaluation
  float gamma = p.gamma[c];
  double2 s = ch.template pairs<true, true>(ch.pos0, gamma, ch.gLo);
  s = ch.reduce(s.x, s.y);
  float gg = (float)(s.x + (double)(gamma * p.inv_sg2));
  double U = s.y + 0.5 * (double)gamma * (double)gamma * (double)p.inv_sg2;
  int count = 0;

  for (int t = 0; t < p.iters; ++t) {
    const float* m0 = p.mom_L + ((size_t)c * p.iters + t) * pos_n + row0 * DIM;
    double m2 = 0.0;
    for (int e = tid; e < own; e += kThreads) {
      const float m = m0[e];
      m2 += (double)m * (double)m;
      const float mh = m - p.half_eps * ch.gLo[e];
      const float x = ch.Lo[e] + p.eps * mh;
      ch.mL[e] = mh;
      ch.Ln[e] = x;
      ch.publish(pb ^ 1, e, x);
    }
    pb ^= 1;
    const float mg0 = p.mom_g[(size_t)c * p.iters + t];
    s = ch.reduce(m2, 0.0);
    const double K0 = 0.5 * (s.x + (double)mg0 * (double)mg0);
    float mg = mg0 - p.half_eps * gg;
    float gn = gamma + p.eps * mg;
    float ggn = gg;
    for (int st = 0; st < p.steps; ++st) {
      const bool more = st + 1 < p.steps;
      s = ch.template pairs<true, false>(ch.pos(pb), gn, ch.gLn);
      __syncthreads();   // the rows' gradient, written by each warp's lane 0
      for (int e = tid; e < own; e += kThreads) {
        const float m = ch.mL[e] - p.eps * ch.gLn[e];
        ch.mL[e] = m;
        if (more) {
          const float x = ch.Ln[e] + p.eps * m;
          ch.Ln[e] = x;
          ch.publish(pb ^ 1, e, x);
        }
      }
      if (more) pb ^= 1;
      s = ch.reduce(s.x, 0.0);
      ggn = (float)(s.x + (double)(gn * p.inv_sg2));
      mg = mg - p.eps * ggn;
      if (more) gn = gn + p.eps * mg;
    }
    // The last full kick overshot by half a step: undo it.
    double k1 = 0.0;
    for (int e = tid; e < own; e += kThreads) {
      const float m = ch.mL[e] + p.half_eps * ch.gLn[e];
      k1 += (double)m * (double)m;
    }
    mg = mg + p.half_eps * ggn;
    const double2 pu = ch.template pairs<false, true>(ch.pos(pb), gn, nullptr);
    s = ch.reduce(k1, pu.y);
    const double Un = s.y + 0.5 * (double)gn * (double)gn * (double)p.inv_sg2;
    const double K1 = 0.5 * (s.x + (double)mg * (double)mg);
    const float lu = logf(p.u[(size_t)c * p.iters + t]);
    if ((double)lu < U + K0 - Un - K1) {
      for (int e = tid; e < own; e += kThreads) {
        ch.Lo[e] = ch.Ln[e];
        ch.gLo[e] = ch.gLn[e];
      }
      gamma = gn;
      gg = ggn;
      U = Un;
      ++count;
    }
  }
  float* Lout = p.L_out + (size_t)c * pos_n + row0 * DIM;
  for (int e = tid; e < own; e += kThreads) Lout[e] = ch.Lo[e];
  if (rank == 0 && tid == 0) {
    p.gamma_out[c] = gamma;
    p.count[c] = count;
  }
}

// The bytes of shared memory a CTA uses: ld_hmc_plan's sum.
long long smem_bytes(int N, int dim, int rows, int pos_in_smem,
                     int slab_in_smem) {
  long long b = kRedBytes + kWarpBytes + align16(5LL * rows * dim * 4);
  if (pos_in_smem) b += 2 * align16((long long)N * dim * 4);
  if (slab_in_smem) b += align16((long long)rows * N);
  return b;
}

template <int DIM, bool kPosGlobal>
cudaError_t launch(const Params& p, int C, int cluster, int smem,
                   cudaStream_t stream) {
  auto fn = ld_hmc_kernel<DIM, kPosGlobal>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, C, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int ld_hmc_launch(const float* L, const float* gamma,
                             const float* A, const float* mom_L,
                             const float* mom_g, const float* u, float* L_out,
                             float* gamma_out, int* count, float* pos_g,
                             unsigned char* slab_g, int C, int N, int dim,
                             int iters, int steps, float eps, float half_eps,
                             float inv_sl2, float inv_sg2, int cluster,
                             int rows, int pos_in_smem, int slab_in_smem,
                             int smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C < 1 || C > 65535 || N < 1 || iters < 0 || steps < 1 || rows < 1 ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      (long long)cluster * rows < N ||
      smem != smem_bytes(N, dim, rows, pos_in_smem, slab_in_smem) ||
      (!pos_in_smem && pos_g == nullptr) ||
      (!slab_in_smem && slab_g == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{L, gamma, A, mom_L, mom_g, u, L_out, gamma_out, count, pos_g,
           slab_g, N, iters, steps, rows, slab_in_smem, eps, half_eps,
           inv_sl2, inv_sg2};
  switch (dim) {
#define PGT_CASE(d)                                                       \
  case d:                                                                 \
    return (int)(pos_in_smem ? launch<d, false>(p, C, cluster, smem, s)   \
                             : launch<d, true>(p, C, cluster, smem, s));
    PGT_CASE(1) PGT_CASE(2) PGT_CASE(3) PGT_CASE(4)
    PGT_CASE(5) PGT_CASE(6) PGT_CASE(7) PGT_CASE(8)
#undef PGT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
