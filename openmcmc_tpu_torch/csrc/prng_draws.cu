// prng_draws: the in-kernel random-number layer exposed over a tensor of
// Philox counters, so that it can be held against its plain PyTorch version
// (openmcmc_tpu_torch/fused/prng.py: draws_plain) on its own.
//
// Replaces, as a testable unit, the device functions of
// openmcmc_tpu/fused/prng.py that the spectral smoother inlines (uniform :178,
// normal_icdf :244, erfinv_poly :310, gamma_mt2 :262, gamma_mt :372). One
// thread per counter row: it writes the row's 4 uniforms and 4 inverse-CDF
// normals, and one (lam, tau)-style Gamma pair drawn exactly as the smoother
// draws it for chain = counter[0], sweep = counter[1]. Bound: the Philox
// rounds and logf calls (arithmetic); 36 bytes written per row. A second entry
// point, truncnorm_draws, does the same for erf_poly and truncnorm_draw, and a
// third, gamma_elem_draws, for gamma_mt_elem (prng.py:218), which the mixture
// kernel inlines.
#include <cuda_runtime.h>

#include "prng.cuh"

struct DrawsParams {
  uint32_t seed;
  float rate1;
  float rate2;
  GammaSpec g1;
  GammaSpec g2;
};

__global__ void prng_draws_kernel(DrawsParams prm, const uint32_t* __restrict__ ctr,
                                  float* __restrict__ uni, float* __restrict__ nrm,
                                  float* __restrict__ gam, int n_rows) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const uint32_t* c = ctr + 4 * (size_t)row;
  Philox4 blk = philox4x32_10(c[0], c[1], c[2], c[3], prm.seed, 0u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uni[4 * (size_t)row + j] = uniform_from_bits(blk.x[j]);
    nrm[4 * (size_t)row + j] = normal_icdf_from_bits(blk.x[j]);
  }
  gam[2 * (size_t)row] = gamma_draw(prm.g1, prm.rate1, prm.seed, c[0], c[1]);
  gam[2 * (size_t)row + 1] = gamma_draw(prm.g2, prm.rate2, prm.seed, c[0], c[1]);
}

// The truncated-normal layer the Thomas smoother's truncated sweep inlines
// (erf_poly :295, truncnorm_draw :339), one thread per counter row: erf_poly of
// the row's 4 inputs x, and 4 truncated draws on [lo, hi] from the 4 words of
// the row's Philox block.
__global__ void truncnorm_draws_kernel(uint32_t seed, const uint32_t* __restrict__ ctr,
                                       const float* __restrict__ x, const float* __restrict__ mu,
                                       const float* __restrict__ scale, const float* __restrict__ lo,
                                       const float* __restrict__ hi, float* __restrict__ erf_out,
                                       float* __restrict__ draw_out, int n_rows) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const uint32_t* c = ctr + 4 * (size_t)row;
  Philox4 blk = philox4x32_10(c[0], c[1], c[2], c[3], seed, 0u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t o = 4 * (size_t)row + j;
    erf_out[o] = erf_poly(x[o]);
    draw_out[o] = truncnorm_from_bits(mu[o], scale[o], lo[o], hi[o], blk.x[j]);
  }
}

extern "C" int truncnorm_draws_launch(uint32_t seed, const uint32_t* ctr, const float* x, const float* mu,
                                      const float* scale, const float* lo, const float* hi, float* erf_out,
                                      float* draw_out, int n_rows, cudaStream_t stream) {
  const int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  truncnorm_draws_kernel<<<blocks, threads, 0, stream>>>(seed, ctr, x, mu, scale, lo, hi, erf_out, draw_out,
                                                         n_rows);
  return (int)cudaGetLastError();
}

extern "C" int prng_draws_launch(const DrawsParams* prm, const uint32_t* ctr, float* uni, float* nrm,
                                 float* gam, int n_rows, cudaStream_t stream) {
  const int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  prng_draws_kernel<<<blocks, threads, 0, stream>>>(*prm, ctr, uni, nrm, gam, n_rows);
  return (int)cudaGetLastError();
}

// gamma_mt_elem (prng.py:218) over counter rows (chain, sweep, site0, group),
// one thread per row: element j of the row draws Gamma(a_star) / rate at
// element 4 group + j of the sites site0 .. site0 + 11, as the mixture kernel
// draws its component precisions.
__global__ void gamma_elem_draws_kernel(uint32_t seed, const uint32_t* __restrict__ ctr,
                                        const float* __restrict__ a_star, const float* __restrict__ rate,
                                        float* __restrict__ out, int n_rows) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const uint32_t* c = ctr + 4 * (size_t)row;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const size_t o = 4 * (size_t)row + j;
    out[o] = gamma_mt_elem(a_star[o], rate[o], seed, c[0], c[1], c[2], 4u * c[3] + (uint32_t)j);
  }
}

extern "C" int gamma_elem_draws_launch(uint32_t seed, const uint32_t* ctr, const float* a_star, const float* rate,
                                       float* out, int n_rows, cudaStream_t stream) {
  const int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  gamma_elem_draws_kernel<<<blocks, threads, 0, stream>>>(seed, ctr, a_star, rate, out, n_rows);
  return (int)cudaGetLastError();
}
