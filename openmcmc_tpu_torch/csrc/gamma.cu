// gamma: batched Gamma(a) draws, elementwise over a flat float32 array.
//
// Replaces the TPU kernel openmcmc_tpu/linalg/pallas_gamma.py:_kernel
// (pallas_call at pallas_gamma.py:73, reached through _pallas_gamma_flat :68 and
// the batching rule of gamma :93). Per element, in the JAX kernel's operation
// order (linalg/gamma.py: gamma_plain is the plain version):
//   a_eff = a < 1 ? a + 1 : a,  d = a_eff - 1/3,  c = 1 / sqrt(9 d)
//   6 rounds: x = sqrt(-2 log u1) cos(2 pi u2),  v = (1 + c x)^3,
//             ok = v > 0 && log u < 0.5 x x + d - d v + d log(v > 0 ? v : 1),
//             the first ok round's d v wins (d if none)
//   a < 1:    value = value * u_b^(1 / a)
// The uniforms are (i24 + 0.5) 2^-24 from the top 24 bits of Philox4x32-10
// (philox.cuh): key (seed, 0), counter (0, 0, site, j / 4), word j % 4 for
// element j; round r reads u1 at site 3r, u2 at 3r + 1, u at 3r + 2, and the
// boost reads site 18. The stream does not depend on the launch geometry.
//
// Design: one thread per group of four elements, so one Philox call per site
// serves all four; a grid-stride loop covers any n. Nothing is shared between
// threads. Built with --fmad=false like the other sources, so each product and
// sum rounds as the plain version's separate PyTorch operations do.
//
// What bounds it: 8 bytes per draw (a in, the draw out) against the float32
// operations the draw needs: the set-up, about 1.02 rounds of 35 to the first
// acceptance (a boosted shape of at least 1 accepts a round with probability
// above 0.95) and the boost's powf where a < 1, about 45 in all; so at 2^24
// draws 0.040 ms by bytes (chip_smoke.py counts the rounds from the run's
// bits). The kernel runs all six rounds for every draw, as the TPU kernel does,
// and draws their 18 Philox blocks: five rounds of that work cannot change the
// draw, and an early exit per element would leave the output bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prng.cuh"

static constexpr int kRounds = 6;
static constexpr int kThreads = 256;
static constexpr int kMaxBlocks = 132 * 16;

__global__ void gamma_kernel(uint32_t seed, long long n, const float* __restrict__ a, float* __restrict__ out) {
  const long long groups = (n + 3) / 4;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const long long base = 4 * g;
    float av[4], d[4], c[4], value[4];
    bool boost[4], accepted[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      av[e] = base + e < n ? a[base + e] : 1.0f;
      boost[e] = av[e] < 1.0f;
      const float a_eff = boost[e] ? av[e] + 1.0f : av[e];
      d[e] = a_eff - (1.0f / 3.0f);
      c[e] = 1.0f / sqrtf(9.0f * d[e]);
      value[e] = d[e];
      accepted[e] = false;
    }
    const uint32_t j4 = (uint32_t)g;
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
      const Philox4 b1 = site_block(seed, 0u, 0u, (uint32_t)(3 * r), j4);
      const Philox4 b2 = site_block(seed, 0u, 0u, (uint32_t)(3 * r + 1), j4);
      const Philox4 b3 = site_block(seed, 0u, 0u, (uint32_t)(3 * r + 2), j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float u1 = uniform_from_bits(b1.x[e]);
        const float u2 = uniform_from_bits(b2.x[e]);
        const float x = sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2);
        const float t = 1.0f + c[e] * x;
        const float v = t * (t * t);
        const float u = uniform_from_bits(b3.x[e]);
        const float rhs = 0.5f * x * x + d[e] - d[e] * v + d[e] * logf(v > 0.0f ? v : 1.0f);
        const bool ok = v > 0.0f && logf(u) < rhs;
        if (ok && !accepted[e]) value[e] = d[e] * v;
        accepted[e] = accepted[e] || ok;
      }
    }
    const Philox4 bb = site_block(seed, 0u, 0u, (uint32_t)(3 * kRounds), j4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (base + e >= n) continue;
      float v = value[e];
      if (boost[e]) v = v * powf(uniform_from_bits(bb.x[e]), 1.0f / av[e]);
      out[base + e] = v;
    }
  }
}

extern "C" int gamma_launch(uint32_t seed, long long n, const float* a, float* out, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  gamma_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(seed, n, a, out);
  return (int)cudaGetLastError();
}
