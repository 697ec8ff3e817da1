// spectral_smoother: the whole GMRF-smoother Gibbs run in pencil
// eigencoordinates, every sweep for every chain in one launch.
//
// Replaces the TPU kernel openmcmc_tpu/fused/spectral.py:_make_smoother_kernel
// (pallas_call at spectral.py:527). Model: y ~ N(b, (tau D)^-1),
// b ~ N(mu0, (lam P0)^-1), Gamma priors on lam and tau. With V'DV = I and
// V'P0V = diag(s) (host f64 eigendecomposition), one sweep per chain is
//   w_k ~ N((tau wy_k + lam s_k wmu_k) / (lam s_k + tau), 1 / (lam s_k + tau))
//   q_lam = sum s_k (w_k - wmu_k)^2,  q_tau = sum (wy_k - w_k)^2
//   lam ~ Gamma(a_lam + p/2, b_lam + q_lam/2), tau ~ Gamma(a_tau + p/2, b_tau + q_tau/2)
//   log_post (analytic), and on stored sweeps b = V w.
//
// Design: one warp per chain. Lanes cover the eigencoordinates four at a time
// (one Philox block per four elements, site 0), the two quadratic forms reduce
// with __shfl_xor_sync (a butterfly, so every lane holds the same bits), and
// the (lam, tau) pair is drawn by lane 0 (lam) and lane 1 (tau) side by side,
// then broadcast with __shfl_sync. Stored sweeps follow store_index semantics
// (in-kernel thinning, openmcmc_tpu/fused/layout.py:6), each into the stored
// (chains, n_keep, p) layout. Where p <= 256 (store_w) each lane writes its four
// w straight from registers into b's row, one 16-byte store where the row is
// aligned, and spectral_store.cu then turns every stored row into b = V w in
// place, one register-tiled product over all of them. Above p = 256, past that
// product's widest tile, the warp computes b = V w itself (spectral_store.cuh)
// with lanes over field rows, V held transposed (VT[k * p + i] = V[i, k]) in
// global memory, L2-resident up to p = 1024 and streamed beyond (p <= 8192
// works, slowly).
//
// What bounds it at the main path's shapes (p = 100, 8192 chains, 700 sweeps,
// 500 stored): the sweeps' issue -- per coordinate a share of a Philox block, an
// inverse-CDF normal, the w draw and the quadratic forms, one dependent chain a
// warp -- and the store of w, 8192 * 500 * 100 * 4 B = 1.64 GB of writes (about
// 0.5 ms of HBM time, under the sweeps). No shared memory: blocks an SM are
// bounded by registers alone. The per-chain b = V w above p = 256 is bounded by
// its loads: every FMA reads V from L1/L2 and no element of V is reused across
// chains.
#include <cuda_runtime.h>

#include <cstdint>

#include "layout.cuh"
#include "prng.cuh"
#include "spectral_store.cuh"

struct SmootherParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t p;
  int32_t n_sweeps;  // n_burn + n_keep * n_thin
  int32_t n_burn;    // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  float b_lam;
  float b_tau;
  float p_real;     // p as float32
  float p_log2pi;   // float32(p * log(2 pi))
  float logdet_p0;
  float logdet_d;
  float lgam_lam;   // a_lam log b_lam - lgamma(a_lam)
  float lgam_tau;
  float a_lam_m1;   // a_lam - 1
  float a_tau_m1;
  GammaSpec g_lam;
  GammaSpec g_tau;
  int32_t store_w;  // 1: write w for spectral_store.cu (p <= 256); 0: b = V w here
};

static constexpr int kMaxSmem = 232448;  // 227 KB of dynamic shared memory per block

// STORE_W: write w on stored sweeps; else b = V w from VT (global memory) and a
// per-warp w buffer in shared memory. vec: 16-byte w stores (p % 4 == 0 and out_b
// 16-byte aligned).
template <bool STORE_W>
__global__ void spectral_smoother_kernel(SmootherParams prm, const float* __restrict__ VT,
                                         const float* __restrict__ svec, const float* __restrict__ wy,
                                         const float* __restrict__ wmu, const float* __restrict__ lam0,
                                         const float* __restrict__ tau0, float* __restrict__ out_b,
                                         float* __restrict__ out_lam, float* __restrict__ out_tau,
                                         float* __restrict__ out_lp, int vec) {
  extern __shared__ float smem[];
  const unsigned FULL = 0xffffffffu;
  const int p = prm.p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* wbuf = smem + (size_t)warp * p;  // STORE_W = false only
  const int chain = blockIdx.x * warps + warp;
  if (chain >= prm.n_chains) return;  // no block-wide barrier follows

  float lam = lam0[chain];
  float tau = tau0[chain];
  const int n_groups = (p + 3) / 4;
  const bool tau_lane = lane & 1;
  const GammaSpec gspec = tau_lane ? prm.g_tau : prm.g_lam;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    float* ob = idx < 0 ? nullptr : out_b + ((size_t)chain * prm.n_keep + idx) * p;  // b's row, stored sweeps

    // ---- NormalNormal: b | y, lam, tau is diagonal in w = V^-1 b
    float q_lam = 0.0f, q_tau = 0.0f;
    for (int g = lane; g < n_groups; g += 32) {
      Philox4 blk = site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)g);
      float w4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int k = 4 * g + e;
        if (k < p) {
          float z = normal_icdf_from_bits(blk.x[e]);
          float sk = svec[k], wyk = wy[k], wmuk = wmu[k];
          float dk = lam * sk + tau;
          float w = (tau * wyk + lam * sk * wmuk) / dk + z * rsqrtf(dk);
          float r = w - wmuk;
          q_lam += sk * r * r;
          float t = wyk - w;
          q_tau += t * t;
          w4[e] = w;
          if (!STORE_W) wbuf[k] = w;
        }
      }
      if (STORE_W && ob) {
        if (vec) {
          *reinterpret_cast<float4*>(ob + 4 * g) = make_float4(w4[0], w4[1], w4[2], w4[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * g + e < p) ob[4 * g + e] = w4[e];
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      q_lam += __shfl_xor_sync(FULL, q_lam, off);
      q_tau += __shfl_xor_sync(FULL, q_tau, off);
    }

    // ---- NormalGamma pair: lane 0 draws lam, lane 1 tau (others duplicate)
    float rate = tau_lane ? (prm.b_tau + 0.5f * q_tau) : (prm.b_lam + 0.5f * q_lam);
    float drawn = gamma_draw(gspec, rate, prm.seed, (uint32_t)chain, (uint32_t)it);
    lam = __shfl_sync(FULL, drawn, 0);
    tau = __shfl_sync(FULL, drawn, 1);

    if (idx < 0) continue;

    // ---- analytic log posterior (the TPU kernel's convention)
    if (lane == 0) {
      float log_like = 0.5f * (prm.p_real * logf(tau) + prm.logdet_d - prm.p_log2pi - tau * q_tau);
      float log_prior_b = 0.5f * (prm.p_real * logf(lam) + prm.logdet_p0 - prm.p_log2pi - lam * q_lam);
      float log_lam = prm.lgam_lam + prm.a_lam_m1 * logf(lam) - prm.b_lam * lam;
      float log_tau = prm.lgam_tau + prm.a_tau_m1 * logf(tau) - prm.b_tau * tau;
      size_t o = (size_t)chain * prm.n_keep + idx;
      out_lam[o] = lam;
      out_tau[o] = tau;
      out_lp[o] = log_like + log_prior_b + log_lam + log_tau;
    }

    if (!STORE_W) {
      // ---- b = V w, lanes over field rows: coalesced row writes
      __syncwarp();
      store_vw(VT, wbuf, ob, p, lane);
      __syncwarp();
    }
  }
}

extern "C" int spectral_smoother_launch(const SmootherParams* prm, const float* VT, const float* svec,
                                        const float* wy, const float* wmu, const float* lam0,
                                        const float* tau0, float* out_b, float* out_lam, float* out_tau,
                                        float* out_lp, cudaStream_t stream) {
  const int p = prm->p;
  int warps = 8;
  if (prm->store_w) {
    const int vec = p % 4 == 0 && ((uintptr_t)out_b & 15) == 0;
    const int blocks = (prm->n_chains + warps - 1) / warps;
    spectral_smoother_kernel<true><<<blocks, 32 * warps, 0, stream>>>(*prm, VT, svec, wy, wmu, lam0, tau0,
                                                                       out_b, out_lam, out_tau, out_lp, vec);
    return (int)cudaGetLastError();
  }
  const size_t wbytes = (size_t)p * sizeof(float);
  while (warps > 1 && warps * wbytes > (size_t)kMaxSmem) warps /= 2;
  const size_t smem = warps * wbytes;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int blocks = (prm->n_chains + warps - 1) / warps;
  const cudaError_t err = cudaFuncSetAttribute(spectral_smoother_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spectral_smoother_kernel<false><<<blocks, 32 * warps, smem, stream>>>(*prm, VT, svec, wy, wmu, lam0, tau0,
                                                                        out_b, out_lam, out_tau, out_lp, 0);
  return (int)cudaGetLastError();
}
