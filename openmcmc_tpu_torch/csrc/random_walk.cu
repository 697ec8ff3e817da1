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
// Design: W lanes per chain, W = p rounded up to a power of two (1 ... 32), so
// 32 / W chains share a warp and lane i of a chain's W holds row i (lanes past p
// are masked: they read row 0's constants and their terms enter no sum). Each
// lane takes its own row's Philox word (word i % 4 of block (chain, sweep, 0,
// i / 4)), its proposal, both truncnorm_logpdf terms and its log-density terms,
// all rows at once; the sums then gather the terms across the chain's lanes
// with width-W shuffles and add them one at a time in ascending row order, the
// log density and the density correction interleaved. Every lane of a chain
// carries the same log pi, accept decision and step scale (the accept uniform,
// site 1, and the adaptation run on each). A row's constants (S1, S2, mu, tau,
// lam, h0, step0, lo, hi) sit in its lane's registers; a chain's p stored floats
// go out in one coalesced access. At rw_box's p = 32 a chain is a warp, 4096
// chains about 31 warps an SM; at rw's p = 1 a lane is a chain, as before.
//
// What bounds it on an H100: issue. A truncated sweep is about 630 issued warp
// instructions a chain at p = 32 (the lanes' truncated draw and two log
// densities, then 4p shuffles and adds); with 31 warps an SM the latency of
// each chain's ascending sums is hidden behind the other warps.
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

static constexpr int kThreads = 32;  // a warp a block: 4096 chains at p = 32 are 31 blocks an SM
static constexpr int kMaxP = 32;
static constexpr unsigned kFull = 0xffffffffu;

// v of row k of this lane's chain: a width-W shuffle
template <int W>
__device__ __forceinline__ float row_of(float v, int k) {
  return W == 1 ? v : __shfl_sync(kFull, v, k, W);
}

// cnst - sum_k [lik_k + pri_k], one row at a time in ascending order (the JAX
// kernel's order): total = total - lik_k - pri_k
template <int W>
__device__ __forceinline__ float log_post(float cnst, float lik, float pri, int p) {
  float total = cnst;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < p) total = total - row_of<W>(lik, k) - row_of<W>(pri, k);
  }
  return total;
}

// This lane's row of log pi: the likelihood and prior terms, the JAX kernel's expressions.
struct Terms {
  float lik, pri;
};

__device__ __forceinline__ Terms row_terms(float h, float n_obs, float s1, float s2, float mu, float tau,
                                           float lam) {
  const float quad = s2 - 2.0f * h * s1 + n_obs * h * h;
  const float r = h - mu;
  return {0.5f * tau * quad, 0.5f * lam * (r * r)};
}

__device__ __forceinline__ uint32_t word_of(const Philox4& blk, int e) {
  return (e & 2) ? ((e & 1) ? blk.x[3] : blk.x[2]) : ((e & 1) ? blk.x[1] : blk.x[0]);
}

template <int W, bool TRUNC>
__global__ void __launch_bounds__(kThreads)
    random_walk_kernel(RwParams prm, const float* __restrict__ scal, float* __restrict__ out_h,
                       float* __restrict__ out_lp, float* __restrict__ out_acc, float* __restrict__ out_total,
                       float* __restrict__ out_log_step) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int chain = g / W, i = g % W;  // W divides the warp, so a chain's lanes share it
  const int p = prm.p;
  const bool live = chain < prm.n_chains, row = i < p;
  const int ic = row ? i : 0;
  const float s1 = scal[ic], s2 = scal[p + ic], mu = scal[2 * p + ic], tau = scal[3 * p + ic],
              lam = scal[4 * p + ic], stp = scal[6 * p + ic];
  const float lo = TRUNC ? scal[7 * p + ic] : 0.0f, hi = TRUNC ? scal[8 * p + ic] : 0.0f;
  const float n_obs = prm.n_obs;

  float h = 0.0f + scal[5 * p + ic];
  const Terms t = row_terms(h, n_obs, s1, s2, mu, tau, lam);
  float lp = log_post<W>(prm.cnst, t.lik, t.pri, p);
  float acc = 0.0f, log_scale = 0.0f;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    const float scale = prm.adapt ? expf(log_scale) : 1.0f;
    const float step = stp * scale;
    const uint32_t bits = word_of(site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)(i / 4)), i % 4);
    float hp, fwd = 0.0f, rev = 0.0f;
    if (TRUNC) {
      hp = truncnorm_from_bits(h, step, lo, hi, bits);
      fwd = truncnorm_logpdf(h, hp, step, lo, hi);
      rev = truncnorm_logpdf(hp, h, step, lo, hi);
    } else {
      hp = h + step * normal_icdf_from_bits(bits);
    }
    const Terms tp = row_terms(hp, n_obs, s1, s2, mu, tau, lam);
    // two independent ascending sums (unrolled, so their steps interleave): log
    // pi(h') and the density correction, corr = corr + fwd_k - rev_k
    const float lp_prop = log_post<W>(prm.cnst, tp.lik, tp.pri, p);
    float corr = 0.0f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (TRUNC && k < p) {
        corr = corr + row_of<W>(fwd, k);
        corr = corr - row_of<W>(rev, k);
      }
    }
    const float log_accept = TRUNC ? lp_prop - lp + corr : lp_prop - lp;
    const float u = uniform_from_bits(site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 1u, 0u).x[0]);
    const bool accept = logf(u) < log_accept;
    if (accept) {
      h = hp;
      lp = lp_prop;
    }
    acc = acc + (accept ? 1.0f : 0.0f);
    if (prm.adapt && it < prm.n_burn) {
      const float alpha = expf(fminf(log_accept, 0.0f));
      log_scale = log_scale + prm.rate * (alpha - prm.target);
    }

    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    if (idx < 0 || !live) continue;
    const size_t o = (size_t)chain * prm.n_keep + idx;
    if (row) out_h[o * p + i] = h;
    if (i == 0) {
      out_lp[o] = lp;
      out_acc[o] = accept ? 1.0f : 0.0f;
    }
  }
  if (live && i == 0) {
    out_total[chain] = acc;
    out_log_step[chain] = log_scale + prm.log_step0;
  }
}

template <bool TRUNC>
static void dispatch(const RwParams& prm, const float* scal, float* out_h, float* out_lp, float* out_acc,
                     float* out_total, float* out_log_step, cudaStream_t stream) {
#define RW_CASE(W)                                                                                    \
  case W: {                                                                                           \
    const int blocks = (int)(((long long)prm.n_chains * W + kThreads - 1) / kThreads);              \
    random_walk_kernel<W, TRUNC><<<blocks, kThreads, 0, stream>>>(prm, scal, out_h, out_lp, out_acc, \
                                                                  out_total, out_log_step);         \
    break;                                                                                            \
  }
  int w = 1;
  while (w < prm.p) w *= 2;
  switch (w) {
    RW_CASE(1) RW_CASE(2) RW_CASE(4) RW_CASE(8) RW_CASE(16) RW_CASE(32)
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
