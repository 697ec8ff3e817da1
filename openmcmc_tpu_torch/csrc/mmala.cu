// mmala: the whole constant-metric manifold-MALA run, every sweep for every
// chain in one launch, p <= 16.
//
// Replaces the TPU kernel openmcmc_tpu/fused/mmala.py:_make_kernel
// (pallas_call at mmala.py:261). Target: y ~ N(X beta, (tau P)^-1),
// beta ~ N(mu0, (lam Plam)^-1) with tau, lam fixed, so the negative Hessian
// A = tau X'PX + lam Plam is constant and the host prepares A, L = chol(A),
// v = tau X'Py + lam Plam mu0, c = A^-1 v, yPy and the log-determinants. One
// sweep per chain is
//   mu(b) = (1 - s^2/2) b + (s^2/2) c,   b' = mu(b) + s L^-T z   (back substitution)
//   log pi(b) = const - 1/2 (b'Ab + yPy) + b'v
//   log q(x | m) = log|L| - p/2 (log 2 pi + log s^2) - |L'(x - m)|^2 / (2 s^2)
//   log_accept = log pi(b') - log pi(b) + log q(b | mu(b')) - log q(b' | mu(b))
//   (adapting) log s += rate (exp(min(log_accept, 0)) - target) during burn-in
// every step in the JAX kernel's operation order (compiled with --fmad=false,
// like the plain version in openmcmc_tpu_torch/fused/mmala.py): the target's
// quadratic cancels heavily, so its terms are added one by one in that order.
// The constants of a fixed step are folded on the host in float64, as the JAX
// kernel folds them.
//
// Bits: Philox4x32-10 (philox.cuh), key (seed, 0), counter
// (chain, sweep, site, i / 4), word i % 4. Site 0 holds the p normals, site 1
// the accept uniform.
//
// Design: one thread per chain, K6's split. For p <= 8 the kernel is templated
// on p, every loop unrolled and b, b', mu, the back-substitution vector in
// registers; 9 <= p <= 16 share one looped instantiation (fully unrolled, K6
// spilled from p = 10 on), its vectors in local memory (L1-resident). A, L, v
// and c (at most 544 floats) sit in shared memory, read at one address by the
// whole warp: a broadcast.
//
// What bounds it on an H100: latency. A sweep is O(p^2) dependent arithmetic
// per chain (the back substitution, two quadratic forms of A and two of L), a
// Philox block per four normals, and the logs and exps of the accept and the
// adaptation; a few thousand chains are one or two warps per SM, far too few
// to hide it.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct MmalaParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t p;
  int32_t n_sweeps;  // n_burn + n_keep * n_thin
  int32_t n_burn;    // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  int32_t adapt;     // Robbins-Monro log step during burn-in
  float n_log2pi;    // float32(N log 2 pi)
  float p_log2pi;    // float32(p log 2 pi)
  float half_p;      // p / 2
  float log_step0;   // float32(log s) of the initial step
  float step;        // the fixed step's constants, folded in float64 on the host:
  float s2;          //   s^2
  float c_keep;      //   1 - s^2/2
  float c_pull;      //   s^2/2
  float c_norm;      //   p/2 (log 2 pi + log s^2)
  float target;
  float rate;
};

static constexpr int kThreads = 32;
static constexpr int kMaxP = 16;

// P > 0: p == P, every loop unrolled; P == 0: the run's p (<= kMaxP), looped.
template <int P>
__global__ void __launch_bounds__(kThreads)
    mmala_kernel(MmalaParams prm, const float* __restrict__ scal, float* __restrict__ out_b,
                 float* __restrict__ out_lp, float* __restrict__ out_acc, float* __restrict__ out_total,
                 float* __restrict__ out_log_step) {
  constexpr int PA = P > 0 ? P : kMaxP;  // array extent
  const int p = P > 0 ? P : prm.p;
  __shared__ float a_s[PA * PA], l_s[PA * PA], v_s[PA], c_s[PA];
  for (int i = threadIdx.x; i < p * p; i += blockDim.x) {
    a_s[i] = scal[i];
    l_s[i] = scal[p * p + i];
  }
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    v_s[i] = scal[2 * p * p + i];
    c_s[i] = scal[2 * p * p + p + i];
  }
  __syncthreads();
  const int chain = blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= prm.n_chains) return;  // no block-wide barrier follows
  const float* b0 = scal + 2 * p * p + 2 * p;
  const float yPy = b0[p], logdet_tauP = b0[p + 1], logdet_lamPlam = b0[p + 2], logdetL = b0[p + 3];
  const float lik_const = 0.5f * (logdet_tauP - prm.n_log2pi);
  const float pri_const = 0.5f * (logdet_lamPlam - prm.p_log2pi);

  // log pi(b) term by term, the JAX kernel's order
  auto log_target = [&](const float* b) {
    float quad = 0.0f, lin = 0.0f;
#pragma unroll
    for (int i = 0; i < p; ++i) {
      lin = lin + v_s[i] * b[i];
#pragma unroll
      for (int j = 0; j < p; ++j) quad = quad + a_s[i * p + j] * b[i] * b[j];
    }
    return lik_const + pri_const - 0.5f * (quad + yPy) + lin;
  };
  // log q(x | m) with the step's s^2 and p/2 (log 2 pi + log s^2)
  auto prop_logq = [&](const float* x, const float* m, float c_norm, float s2) {
    float ssq = 0.0f;
#pragma unroll
    for (int j = 0; j < p; ++j) {
      float w = 0.0f;
#pragma unroll
      for (int i = j; i < p; ++i) w = w + l_s[i * p + j] * (x[i] - m[i]);
      ssq = ssq + w * w;
    }
    return logdetL - c_norm - 0.5f * ssq / s2;
  };

  float b[PA], bp[PA], mu_cur[PA], mu_prop[PA];
#pragma unroll
  for (int i = 0; i < p; ++i) b[i] = 0.0f + b0[i];
  float lp = log_target(b);
  float acc = 0.0f, log_step = prm.log_step0;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    float step = prm.step, s2 = prm.s2, c_keep = prm.c_keep, c_pull = prm.c_pull, c_norm = prm.c_norm;
    if (prm.adapt) {
      step = expf(log_step);
      s2 = step * step;
      c_keep = 1.0f - 0.5f * s2;
      c_pull = 0.5f * s2;
      c_norm = prm.half_p * (1.83787706640934534f + logf(s2));
    }
    // z into bp, then the back substitution L' eps = z in place
#pragma unroll
    for (int g = 0; g < (p + 3) / 4; ++g) {
      const Philox4 blk = site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * g + e < p) bp[4 * g + e] = normal_icdf_from_bits(blk.x[e]);
      }
    }
#pragma unroll
    for (int i = p - 1; i >= 0; --i) {
      float w = bp[i];
#pragma unroll
      for (int k = i + 1; k < p; ++k) w = w - l_s[k * p + i] * bp[k];
      bp[i] = w / l_s[i * p + i];
    }
#pragma unroll
    for (int i = 0; i < p; ++i) {
      mu_cur[i] = c_keep * b[i] + c_pull * c_s[i];
      bp[i] = mu_cur[i] + step * bp[i];
    }
    const float lp_prop = log_target(bp);
#pragma unroll
    for (int i = 0; i < p; ++i) mu_prop[i] = c_keep * bp[i] + c_pull * c_s[i];
    const float log_accept = lp_prop - lp + prop_logq(b, mu_prop, c_norm, s2) - prop_logq(bp, mu_cur, c_norm, s2);
    const float u = uniform_from_bits(site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 1u, 0u).x[0]);
    const bool accept = logf(u) < log_accept;
    if (accept) {
#pragma unroll
      for (int i = 0; i < p; ++i) b[i] = bp[i];
      lp = lp_prop;
    }
    acc = acc + (accept ? 1.0f : 0.0f);
    if (prm.adapt && it < prm.n_burn) {
      const float alpha = expf(fminf(log_accept, 0.0f));
      log_step = log_step + prm.rate * (alpha - prm.target);
    }

    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    if (idx < 0) continue;
    const size_t o = (size_t)chain * prm.n_keep + idx;
    float* ob = out_b + o * p;
#pragma unroll
    for (int i = 0; i < p; ++i) ob[i] = b[i];
    out_lp[o] = lp;
    out_acc[o] = accept ? 1.0f : 0.0f;
  }
  out_total[chain] = acc;
  out_log_step[chain] = log_step;
}

template <int P>
static void launch(const MmalaParams& prm, const float* scal, float* out_b, float* out_lp, float* out_acc,
                   float* out_total, float* out_log_step, cudaStream_t stream) {
  const int blocks = (prm.n_chains + kThreads - 1) / kThreads;
  mmala_kernel<P><<<blocks, kThreads, 0, stream>>>(prm, scal, out_b, out_lp, out_acc, out_total, out_log_step);
}

extern "C" int mmala_launch(const MmalaParams* prm, const float* scal, float* out_b, float* out_lp, float* out_acc,
                            float* out_total, float* out_log_step, cudaStream_t stream) {
#define MMALA_CASE(P)                                                                \
  case P:                                                                            \
    launch<P>(*prm, scal, out_b, out_lp, out_acc, out_total, out_log_step, stream); \
    break;
  if (prm->p < 1 || prm->p > kMaxP) return (int)cudaErrorInvalidValue;
  switch (prm->p) {
    MMALA_CASE(1) MMALA_CASE(2) MMALA_CASE(3) MMALA_CASE(4)
    MMALA_CASE(5) MMALA_CASE(6) MMALA_CASE(7) MMALA_CASE(8)
    default:
      launch<0>(*prm, scal, out_b, out_lp, out_acc, out_total, out_log_step, stream);
  }
#undef MMALA_CASE
  return (int)cudaGetLastError();
}
