// random_walk: the whole random-walk Metropolis run on a p-vector location,
// every sweep for every chain in one launch, p <= 32.
//
// Replaces the TPU kernel openmcmc_tpu/fused/random_walk.py:_make_kernel
// (pallas_call at random_walk.py:269). Model: y_ij ~ N(h_i, 1/tau_i),
// h_i ~ N(mu_i, 1/lam_i), the data entering through S1_i = sum_j y_ij,
// S2_i = sum_j y_ij^2 and N. One sweep per chain is
//   h'_i = h_i + step_i z_i                      (or a truncated draw on [lo_i, hi_i])
//   log pi(h') = const - sum_i [tau_i/2 (S2_i - 2 h'_i S1_i + N h'_i^2) + lam_i/2 (h'_i - mu_i)^2]
//   log_accept = log pi(h') - log pi(h) (+ sum_i [log q(h_i | h'_i) - log q(h'_i | h_i)] truncated)
//   accept if log u < log_accept; the current log pi rides the carry
//   (adapting) log_scale += rate (exp(min(log_accept, 0)) - target) during burn-in
// with step_i = step0_i exp(log_scale), every step in the JAX kernel's
// operation order (compiled with --fmad=false, like the plain version in
// openmcmc_tpu_torch/fused/random_walk.py). The likelihood form cancels heavily
// (S2 is about 1.4e5 at the reference's example 2), so its terms are added one
// by one in that order. const and log(step0_0) come from the host.
//
// Bits: Philox4x32-10 (philox.cuh), key (seed, 0), counter
// (chain, sweep, site, i / 4), word i % 4. Site 0 holds the p proposal normals
// (truncated: the p truncated-draw uniforms), site 1 the accept uniform.
//
// Design: one thread per chain, K6's. For p <= 8 the kernel is templated on p,
// every loop unrolled and h, h' in registers; 9 <= p <= 32 share one looped
// instantiation whose rows sit in local memory (L1-resident). The p-row
// constants (S1, S2, mu, tau, lam, step0, lo, hi) sit in shared memory, read at
// one address by the whole warp: a broadcast.
//
// What bounds it on an H100: latency. A sweep is a chain of dependent steps per
// chain (p Philox blocks, the inverse-CDF normals or the erf pair, inverse erf
// and two logs per truncated row, a log and an exp for the accept and the
// adaptation), and a few thousand chains are one or two warps per SM, far too
// few to hide it. Several chains per thread, or a few lanes per chain, is work
// for a later change.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct RwParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t p;
  int32_t n_sweeps;  // n_burn + n_keep * n_thin
  int32_t n_burn;    // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  int32_t trunc;     // truncated proposals on [lo, hi]
  int32_t adapt;     // Robbins-Monro log step-scale during burn-in
  float n_obs;       // N as float32
  float cnst;        // the log posterior's normalising constant (host, float32)
  float log_step0;   // float32 log(step0_0), added to the stored log scale
  float target;
  float rate;
};

static constexpr int kThreads = 32;
static constexpr int kMaxP = 32;

// log pi(h) term by term, the JAX kernel's order.
template <int P>
__device__ __forceinline__ float log_post(const float* h, int p, float n_obs, float cnst, const float* s1,
                                          const float* s2, const float* mu, const float* tau, const float* lam) {
  float total = cnst;
#pragma unroll
  for (int i = 0; i < (P > 0 ? P : p); ++i) {
    const float quad = s2[i] - 2.0f * h[i] * s1[i] + n_obs * h[i] * h[i];
    const float r = h[i] - mu[i];
    total = total - 0.5f * tau[i] * quad - 0.5f * lam[i] * (r * r);
  }
  return total;
}

// P > 0: p == P, every loop unrolled; P == 0: the run's p (<= kMaxP), looped.
template <int P, bool TRUNC>
__global__ void __launch_bounds__(kThreads)
    random_walk_kernel(RwParams prm, const float* __restrict__ scal, float* __restrict__ out_h,
                       float* __restrict__ out_lp, float* __restrict__ out_acc, float* __restrict__ out_total,
                       float* __restrict__ out_log_step) {
  constexpr int PA = P > 0 ? P : kMaxP;  // array extent
  const int p = P > 0 ? P : prm.p;
  __shared__ float s_s[9 * PA];
  for (int i = threadIdx.x; i < (TRUNC ? 9 : 7) * p; i += blockDim.x) s_s[i] = scal[i];
  __syncthreads();
  const int chain = blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= prm.n_chains) return;  // no block-wide barrier follows
  const float *s1 = s_s, *s2 = s_s + p, *mu = s_s + 2 * p, *tau = s_s + 3 * p, *lam = s_s + 4 * p;
  const float *h0 = s_s + 5 * p, *stp = s_s + 6 * p, *lo = s_s + 7 * p, *hi = s_s + 8 * p;

  float h[PA], hp[PA];
#pragma unroll
  for (int i = 0; i < p; ++i) h[i] = 0.0f + h0[i];
  float lp = log_post<P>(h, p, prm.n_obs, prm.cnst, s1, s2, mu, tau, lam);
  float acc = 0.0f, log_scale = 0.0f;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    const float scale = prm.adapt ? expf(log_scale) : 1.0f;
    float corr = 0.0f;
#pragma unroll
    for (int g = 0; g < (p + 3) / 4; ++g) {
      const Philox4 blk = site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * g + e;
        if (i < p) {
          const float step = stp[i] * scale;
          if (TRUNC) {
            hp[i] = truncnorm_from_bits(h[i], step, lo[i], hi[i], blk.x[e]);
          } else {
            hp[i] = h[i] + step * normal_icdf_from_bits(blk.x[e]);
          }
        }
      }
    }
    if (TRUNC) {
#pragma unroll
      for (int i = 0; i < p; ++i) {
        const float step = stp[i] * scale;
        corr = corr + truncnorm_logpdf(h[i], hp[i], step, lo[i], hi[i]);
        corr = corr - truncnorm_logpdf(hp[i], h[i], step, lo[i], hi[i]);
      }
    }
    const float lp_prop = log_post<P>(hp, p, prm.n_obs, prm.cnst, s1, s2, mu, tau, lam);
    const float log_accept = TRUNC ? lp_prop - lp + corr : lp_prop - lp;
    const float u = uniform_from_bits(site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 1u, 0u).x[0]);
    const bool accept = logf(u) < log_accept;
    if (accept) {
#pragma unroll
      for (int i = 0; i < p; ++i) h[i] = hp[i];
      lp = lp_prop;
    }
    acc = acc + (accept ? 1.0f : 0.0f);
    if (prm.adapt && it < prm.n_burn) {
      const float alpha = expf(fminf(log_accept, 0.0f));
      log_scale = log_scale + prm.rate * (alpha - prm.target);
    }

    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    if (idx < 0) continue;
    const size_t o = (size_t)chain * prm.n_keep + idx;
    float* oh = out_h + o * p;
#pragma unroll
    for (int i = 0; i < p; ++i) oh[i] = h[i];
    out_lp[o] = lp;
    out_acc[o] = accept ? 1.0f : 0.0f;
  }
  out_total[chain] = acc;
  out_log_step[chain] = log_scale + prm.log_step0;
}

template <int P, bool TRUNC>
static void launch(const RwParams& prm, const float* scal, float* out_h, float* out_lp, float* out_acc,
                   float* out_total, float* out_log_step, cudaStream_t stream) {
  const int blocks = (prm.n_chains + kThreads - 1) / kThreads;
  random_walk_kernel<P, TRUNC><<<blocks, kThreads, 0, stream>>>(prm, scal, out_h, out_lp, out_acc, out_total,
                                                                out_log_step);
}

template <bool TRUNC>
static void dispatch(const RwParams& prm, const float* scal, float* out_h, float* out_lp, float* out_acc,
                     float* out_total, float* out_log_step, cudaStream_t stream) {
#define RW_CASE(P)                                                                           \
  case P:                                                                                    \
    launch<P, TRUNC>(prm, scal, out_h, out_lp, out_acc, out_total, out_log_step, stream); \
    break;
  switch (prm.p) {
    RW_CASE(1) RW_CASE(2) RW_CASE(3) RW_CASE(4)
    RW_CASE(5) RW_CASE(6) RW_CASE(7) RW_CASE(8)
    default:
      launch<0, TRUNC>(prm, scal, out_h, out_lp, out_acc, out_total, out_log_step, stream);
  }
#undef RW_CASE
}

extern "C" int random_walk_launch(const RwParams* prm, const float* scal, float* out_h, float* out_lp,
                                  float* out_acc, float* out_total, float* out_log_step, cudaStream_t stream) {
  if (prm->p < 1 || prm->p > kMaxP) return (int)cudaErrorInvalidValue;
  if (prm->trunc) {
    dispatch<true>(*prm, scal, out_h, out_lp, out_acc, out_total, out_log_step, stream);
  } else {
    dispatch<false>(*prm, scal, out_h, out_lp, out_acc, out_total, out_log_step, stream);
  }
  return (int)cudaGetLastError();
}
