// spectral_mmala: the whole constant-metric manifold-MALA run in pencil
// eigencoordinates, every sweep for every chain in one launch, p <= 256.
//
// Replaces the TPU kernel openmcmc_tpu/fused/spectral.py:_make_mmala_kernel
// (pallas_call at spectral.py:837). Target: y ~ N(X beta, (tau P)^-1),
// beta ~ N(mu0, (lam Plam)^-1) with tau, lam fixed. The host diagonalizes the
// constant metric once (V' Plam V = I, V'X'PXV = diag(s), d = tau s + lam) and
// gives cw = V'v / d (the posterior mean in w), isd = rsqrt(d), w0 and the
// target's constant at its mode; in w = V^-1 beta one sweep per chain is
//   mu(w) = w + s^2/2 (cw - w),   w' = mu(w) + s z isd
//   log pi(w) = log_const - 1/2 sum d (w - cw)^2
//   log q(x | m) = 1/2 sum log d - p/2 (log 2 pi + log s^2) - sum d (x - m)^2 / (2 s^2)
//   log_accept = log pi(w') - log pi(w) + log q(w | mu(w')) - log q(w' | mu(w))
//   (adapting) log s += rate (exp(min(log_accept, 0)) - target) during burn-in
// and on stored sweeps w into beta's row of the output, which spectral_store.cu
// then turns into beta = V w in place; every step as the plain version in
// openmcmc_tpu_torch/fused/spectral.py computes it (compiled with
// --fmad=false). Two departures from the JAX kernel: it sums
// -1/2 (sum d w^2 + yPy) + sum vw w in float32, which at yPy ~ 5e7 rounds by
// more than the accept ratio itself, where this kernel takes the target about
// its mode with the constant in float64 on the host; and it carries the adapted
// log step at full (p_pad, chains) shape for a Mosaic limitation, where this
// kernel carries one value per chain.
//
// The three sums (the target's and the two proposal forms) run in K5's fixed
// order (spectral.py: sum_windows): p rounded up to 8, then windows of 32 rows,
// each summed in row order by a lane of its own (lanes 8q + v for sum q, window
// v), then the window sums in order.
//
// Bits: Philox4x32-10 (philox.cuh), key (seed, 0), counter
// (chain, sweep, site, i / 4), word i % 4. Site 0 holds the p normals (the JAX
// kernel draws p rounded up to 8), site 1 the accept uniform.
//
// Design: K5's sweep. One warp per chain; lanes cover the coordinates four at a
// time (one Philox block per four), w and w' sit in the warp's shared buffers,
// the sums run on the lanes above, every lane takes the same accept decision,
// and on stored sweeps the warp writes w, coalesced, into the driver's
// (chains, n_keep, p) layout. V is not read here: the product with V runs over
// every stored row at once in spectral_store.cu.
//
// What bounds it at the main path's shapes (p = 256, 4096 chains, 700 sweeps,
// 500 stored): bytes, the 2.1 GB of w rows it writes (0.63 ms at 3.35 TB/s);
// its operations, 55 FLOP a coordinate and 40 a sweep, come to 4.0e10 (0.60 ms
// at 67 TFLOP/s). It runs far from both: with a warp a chain, the window sums
// keep 24 lanes busy and the accept one value while the others wait.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct MmalaWideParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t p;
  int32_t n_sweeps;     // n_burn + n_keep * n_thin
  int32_t n_burn;       // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  int32_t sum_windows;  // windows of 32 rows in the sums (<= 8)
  int32_t sum_lo;       // rows of zeros before row 0 in the first window
  int32_t adapt;        // Robbins-Monro log step during burn-in
  float log_const;      // log pi at its mode (host, float64 then float32)
  float half_logdetA;   // 1/2 sum log d
  float half_p;         // p / 2
  float log_step0;      // float32(log s) of the initial step
  float step;           // the fixed step's constants, folded in float64 on the host:
  float s2;             //   s^2
  float c_pull;         //   s^2 / 2
  float c_norm;         //   p/2 (log 2 pi + log s^2)
  float target;
  float rate;
};

static constexpr int kWarps = 8;

// Window sum of quantity q (0: d (w' - cw)^2, 1: d (w - mu(w'))^2,
// 2: d (w' - mu(w))^2) held by lane 8q + v for window v, then all three totals
// in window order on every lane.
__device__ __forceinline__ void three_sums(const float* wb, const float* pb, const float* dv, const float* cw,
                                           float c_pull, int p, int n_win, int lo, int lane, float* tot) {
  const unsigned FULL = 0xffffffffu;
  const int q = lane >> 3, win = lane & 7;
  float acc = 0.0f;
  if (q < 3 && win < n_win) {
    for (int j = 0; j < 32; ++j) {
      const int k = 32 * win + j - lo;
      if (k >= 0 && k < p) {
        const float w = wb[k], wp = pb[k];
        float r;
        if (q == 0) {
          r = wp - cw[k];
        } else if (q == 1) {
          r = w - (wp + c_pull * (cw[k] - wp));
        } else {
          r = wp - (w + c_pull * (cw[k] - w));
        }
        acc = acc + dv[k] * r * r;
      }
    }
  }
  tot[0] = tot[1] = tot[2] = 0.0f;
  for (int v = 0; v < n_win; ++v) {
#pragma unroll
    for (int t = 0; t < 3; ++t) tot[t] = tot[t] + __shfl_sync(FULL, acc, 8 * t + v);
  }
}

__global__ void spectral_mmala_kernel(MmalaWideParams prm, const float* __restrict__ dg, const float* __restrict__ cwg,
                                      const float* __restrict__ isdg, const float* __restrict__ w0,
                                      float* __restrict__ out_b, float* __restrict__ out_lp,
                                      float* __restrict__ out_acc, float* __restrict__ out_total,
                                      float* __restrict__ out_log_step) {
  extern __shared__ float smem[];
  const int p = prm.p;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float *dv = smem, *cw = smem + p, *isd = smem + 2 * p;
  float* wb = smem + 3 * p + (size_t)warp * 2 * p;  // this warp's w
  float* pb = wb + p;                               // and w'
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    dv[i] = dg[i];
    cw[i] = cwg[i];
    isd[i] = isdg[i];
  }
  __syncthreads();
  const int chain = blockIdx.x * warps + warp;
  if (chain >= prm.n_chains) return;  // no block-wide barrier follows

  const int n_groups = (p + 3) / 4;
  for (int k = lane; k < p; k += 32) {
    wb[k] = 0.0f + w0[k];
    pb[k] = wb[k];
  }
  __syncwarp();
  float tot[3];
  three_sums(wb, pb, dv, cw, 0.0f, p, prm.sum_windows, prm.sum_lo, lane, tot);
  float lp = prm.log_const - 0.5f * tot[0];
  float acc = 0.0f, log_step = prm.log_step0;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    float step = prm.step, s2 = prm.s2, c_pull = prm.c_pull, c_norm = prm.c_norm;
    if (prm.adapt) {
      step = expf(log_step);
      s2 = step * step;
      c_pull = 0.5f * s2;
      c_norm = prm.half_p * (1.83787706640934534f + 2.0f * log_step);
    }
    // ---- the proposal, four coordinates per Philox block
    for (int g = lane; g < n_groups; g += 32) {
      const Philox4 blk = site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 0u, (uint32_t)g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * g + e;
        if (k < p) {
          const float w = wb[k];
          const float mu = w + c_pull * (cw[k] - w);
          pb[k] = mu + step * normal_icdf_from_bits(blk.x[e]) * isd[k];
        }
      }
    }
    __syncwarp();

    // ---- target and proposal densities, the accept on every lane
    three_sums(wb, pb, dv, cw, c_pull, p, prm.sum_windows, prm.sum_lo, lane, tot);
    const float lp_prop = prm.log_const - 0.5f * tot[0];
    const float q_fwd = prm.half_logdetA - c_norm - 0.5f * tot[1] / s2;
    const float q_rev = prm.half_logdetA - c_norm - 0.5f * tot[2] / s2;
    const float log_accept = lp_prop - lp + q_fwd - q_rev;
    const float u = uniform_from_bits(site_block(prm.seed, (uint32_t)chain, (uint32_t)it, 1u, 0u).x[0]);
    const bool accept = logf(u) < log_accept;
    __syncwarp();  // every lane has read wb and pb for the sums
    if (accept) {
      for (int k = lane; k < p; k += 32) wb[k] = pb[k];
      lp = lp_prop;
    }
    acc = acc + (accept ? 1.0f : 0.0f);
    if (prm.adapt && it < prm.n_burn) {
      const float alpha = expf(fminf(log_accept, 0.0f));
      log_step = log_step + prm.rate * (alpha - prm.target);
    }
    __syncwarp();

    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    if (idx >= 0) {
      const size_t o = (size_t)chain * prm.n_keep + idx;
      if (lane == 0) {
        out_lp[o] = lp;
        out_acc[o] = accept ? 1.0f : 0.0f;
      }
      for (int k = lane; k < p; k += 32) out_b[o * p + k] = wb[k];
    }
    __syncwarp();  // pb is rewritten by the next sweep, wb read by the row's write
  }
  if (lane == 0) {
    out_total[chain] = acc;
    out_log_step[chain] = log_step;
  }
}

extern "C" int spectral_mmala_launch(const MmalaWideParams* prm, const float* d, const float* cw, const float* isd,
                                     const float* w0, float* out_b, float* out_lp, float* out_acc, float* out_total,
                                     float* out_log_step, cudaStream_t stream) {
  const int p = prm->p;
  if (p < 1 || p > 256 || prm->sum_windows < 1 || prm->sum_windows > 8) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 + 2 * kWarps) * p * sizeof(float);  // at most 19 KB
  const int blocks = (prm->n_chains + kWarps - 1) / kWarps;
  spectral_mmala_kernel<<<blocks, 32 * kWarps, smem, stream>>>(*prm, d, cw, isd, w0, out_b, out_lp, out_acc,
                                                               out_total, out_log_step);
  return (int)cudaGetLastError();
}
