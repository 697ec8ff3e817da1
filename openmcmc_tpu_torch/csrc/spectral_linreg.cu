// spectral_linreg: the whole Bayesian linear-regression Gibbs run in pencil
// eigencoordinates, every sweep for every chain in one launch, p <= 256.
//
// Replaces the TPU kernel openmcmc_tpu/fused/spectral.py:_make_linreg_kernel
// (pallas_call at spectral.py:236). Model: y ~ N(X beta, (tau diag(ptau))^-1),
// beta ~ N(mu, (lam diag(plam))^-1), Gamma priors on tau and lam. With
// V' diag(plam) V = I and V'GV = diag(s), G = X'PX (host f64
// eigendecomposition), one sweep per chain is
//   w_k ~ N((lam wmu_k + tau cv_k) / d_k, 1 / d_k),  d_k = lam + tau s_k
//   q_lam = sum (w_k - wmu_k)^2,  q_tau = max(yPy - 2 sum cv_k w_k + sum s_k w_k^2, 0)
//   (tau, lam) ~ Gamma(a_tau + N/2, b_tau + q_tau/2), Gamma(a_lam + p/2, b_lam + q_lam/2)
//   log_post (analytic), and on stored sweeps w into beta's row of the output,
//   which spectral_store.cu then turns into beta = V w in place.
// It differs from K1 (spectral_smoother.cu) in the precision (lam + tau s, not
// lam s + tau), the mean, both quadratic forms, and the Gamma pair's order:
// tau is the pair's first draw (element 0), lam its second.
//
// Design: K1's sweep. One warp per chain; lanes cover the eigencoordinates four
// at a time (one Philox block per four elements, site 0), w goes to the warp's
// shared buffer, lane 0 draws tau and lane 1 lam side by side, and on stored
// sweeps the warp writes w, coalesced, into the driver's (chains, n_keep, p)
// layout. V is not read here: the product with V runs over every stored row at
// once in spectral_store.cu, which reuses V from registers across rows, where a
// per-chain product loaded V from L1/L2 for every FMA.
//
// The three sums run in one fixed order, the plain version's
// (openmcmc_tpu_torch/fused/spectral.py: sum_windows): p rounded up to 8, then
// windows of 32 rows, each summed in row order by a lane of its own (lanes
// 8q + v for sum q, window v), then the window sums in order. q_tau cancels
// heavily (yPy is large and the residual small), so any other order moves tau
// by far more than the rest of the sweep's rounding.
//
// What bounds it at the main path's shapes (p = 256, 4096 chains, 700 sweeps,
// 500 stored): bytes, the 2.1 GB of w rows it writes (0.63 ms at 3.35 TB/s);
// its operations, 47 FLOP a coordinate (the inverse-CDF normal 30 of them) and
// the Gamma pair, come to 3.5e10 (0.52 ms at 67 TFLOP/s). It runs far from
// both: with a warp a chain, the Gamma pair and the window sums keep a few
// lanes busy while the others wait.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct LinregWideParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t p;
  int32_t n_sweeps;  // n_burn + n_keep * n_thin
  int32_t n_burn;    // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  int32_t sum_windows;  // windows of 32 rows in the sums (<= 8)
  int32_t sum_lo;       // rows of zeros before row 0 in the first window
  float yPy;
  float logdet_plam;
  float logdet_ptau;
  float n_obs;     // N as float32
  float n_log2pi;  // float32(N log(2 pi))
  float p_real;
  float p_log2pi;
  float b_lam;
  float b_tau;
  float lgam_lam;  // a_lam log b_lam - lgamma(a_lam)
  float lgam_tau;
  float a_lam_m1;  // a_lam - 1
  float a_tau_m1;
  GammaSpec g_tau;  // the pair's first draw
  GammaSpec g_lam;
};

__global__ void spectral_linreg_kernel(LinregWideParams prm, const float* __restrict__ svec,
                                       const float* __restrict__ wmu, const float* __restrict__ cv,
                                       const float* __restrict__ lam0, const float* __restrict__ tau0,
                                       float* __restrict__ out_b,
                                       float* __restrict__ out_lam, float* __restrict__ out_tau,
                                       float* __restrict__ out_lp) {
  extern __shared__ float smem[];
  const unsigned FULL = 0xffffffffu;
  const int p = prm.p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* wbuf = smem + (size_t)warp * p;
  const int chain = blockIdx.x * warps + warp;
  if (chain >= prm.n_chains) return;  // no block-wide barrier follows

  float lam = lam0[chain];
  float tau = tau0[chain];
  const int n_groups = (p + 3) / 4;
  const bool lam_lane = lane & 1;
  const GammaSpec gspec = lam_lane ? prm.g_lam : prm.g_tau;
  const int sum_q = lane >> 3;   // 0: q_lam, 1: sum cv w, 2: sum s w^2
  const int sum_win = lane & 7;  // the window this lane sums

  for (int it = 0; it < prm.n_sweeps; ++it) {
    // ---- NormalNormal: beta | y, lam, tau is diagonal in w = V^-1 beta
    for (int g = lane; g < n_groups; g += 32) {
      Philox4 blk = site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int k = 4 * g + e;
        if (k < p) {
          float z = normal_icdf_from_bits(blk.x[e]);
          float dk = lam + tau * svec[k];
          wbuf[k] = (lam * wmu[k] + tau * cv[k]) / dk + z * rsqrtf(dk);
        }
      }
    }
    __syncwarp();

    // ---- the quadratic forms: window sums on 24 lanes, then the windows in order
    float acc = 0.0f;
    if (sum_q < 3 && sum_win < prm.sum_windows) {
      for (int j = 0; j < 32; ++j) {
        const int k = 32 * sum_win + j - prm.sum_lo;
        if (k >= 0 && k < p) {
          const float wk = wbuf[k];
          const float r = wk - wmu[k];
          const float a = sum_q == 0 ? r : (sum_q == 1 ? cv[k] : svec[k] * wk);
          const float b = sum_q == 0 ? r : wk;
          acc = acc + a * b;  // r r, cv w, (s w) w
        }
      }
    }
    float q_lam = 0.0f, s_cw = 0.0f, s_sww = 0.0f;
    for (int v = 0; v < prm.sum_windows; ++v) {
      q_lam = q_lam + __shfl_sync(FULL, acc, v);
      s_cw = s_cw + __shfl_sync(FULL, acc, 8 + v);
      s_sww = s_sww + __shfl_sync(FULL, acc, 16 + v);
    }
    const float q_tau = fmaxf(prm.yPy - 2.0f * s_cw + s_sww, 0.0f);

    // ---- NormalGamma pair: lane 0 draws tau, lane 1 lam (others duplicate)
    float rate = lam_lane ? (prm.b_lam + 0.5f * q_lam) : (prm.b_tau + 0.5f * q_tau);
    float drawn = gamma_draw(gspec, rate, prm.seed, (uint32_t)chain, (uint32_t)it);
    tau = __shfl_sync(FULL, drawn, 0);
    lam = __shfl_sync(FULL, drawn, 1);

    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    if (idx >= 0) {
      // ---- analytic log posterior (the TPU kernel's convention)
      if (lane == 0) {
        float log_like = 0.5f * (prm.n_obs * logf(tau) + prm.logdet_ptau - prm.n_log2pi - tau * q_tau);
        float log_beta = 0.5f * (prm.p_real * logf(lam) + prm.logdet_plam - prm.p_log2pi - lam * q_lam);
        float log_lam = prm.lgam_lam + prm.a_lam_m1 * logf(lam) - prm.b_lam * lam;
        float log_tau = prm.lgam_tau + prm.a_tau_m1 * logf(tau) - prm.b_tau * tau;
        size_t o = (size_t)chain * prm.n_keep + idx;
        out_lam[o] = lam;
        out_tau[o] = tau;
        out_lp[o] = log_like + log_beta + log_lam + log_tau;
      }
      float* ob = out_b + ((size_t)chain * prm.n_keep + idx) * p;
      for (int k = lane; k < p; k += 32) ob[k] = wbuf[k];
    }
    __syncwarp();  // wbuf is rewritten by the next sweep
  }
}

extern "C" int spectral_linreg_launch(const LinregWideParams* prm, const float* svec, const float* wmu,
                                      const float* cv, const float* lam0, const float* tau0, float* out_b,
                                      float* out_lam, float* out_tau, float* out_lp, cudaStream_t stream) {
  const int p = prm->p;
  if (p < 1 || p > 256 || prm->sum_windows < 1 || prm->sum_windows > 8) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  const size_t smem = warps * (size_t)p * sizeof(float);  // at most 8 KB
  const int blocks = (prm->n_chains + warps - 1) / warps;
  spectral_linreg_kernel<<<blocks, 32 * warps, smem, stream>>>(*prm, svec, wmu, cv, lam0, tau0, out_b, out_lam,
                                                                out_tau, out_lp);
  return (int)cudaGetLastError();
}
