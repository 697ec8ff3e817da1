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
// What bounds it on an H100: issuing instructions. A draw moves 8 bytes (a in,
// the draw out; 0.040 ms at 2^24 draws) but needs a Philox share, the shape's
// set-up and a Marsaglia-Tsang round of three accurate logf, a sqrtf and a cosf,
// a few hundred instructions. The accurate functions stay: gamma_plain follows
// the kernel bit for bit, and fast intrinsics would move its decisions.
//
// Design: a draw's value is fixed by its first accepted round, and a boosted
// shape of at least 1 accepts round 0 with probability above 0.95, so the
// kernel draws only what some output reads. A block takes tiles of kTile
// elements, one group of four per thread (one Philox call per site serves all
// four), in a grid-stride loop over the tiles:
//   1. every group runs round 0 from its sites 0, 1 and 2, and writes the draws
//      that accepted, with the boost block (site 18) drawn only where such a
//      draw has a < 1;
//   2. a draw that missed round 0 goes into the block's queue in shared memory,
//      sized for the whole tile, so no draw is ever dropped;
//   3. the block's threads take the queued draws one a thread through rounds
//      1 to 5, each from its own group's Philox blocks and word, stopping at
//      the first accepted round, and write them.
// Built with --fmad=false like the other sources, so each product and sum
// rounds as the plain version's separate PyTorch operations do.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prng.cuh"

static constexpr int kRounds = 6;
static constexpr int kThreads = 256;
static constexpr int kTile = 4 * kThreads;
static constexpr int kMaxBlocks = 132 * 16;

// d and c of the (boosted) Marsaglia-Tsang shape.
__device__ __forceinline__ void mt_shape(float a, float& d, float& c) {
  const float a_eff = a < 1.0f ? a + 1.0f : a;
  d = a_eff - (1.0f / 3.0f);
  c = 1.0f / sqrtf(9.0f * d);
}

// One Marsaglia-Tsang round on its three sites' words; an accepted round sets
// value to d v.
__device__ __forceinline__ bool mt_round(float d, float c, uint32_t w1, uint32_t w2, uint32_t w3, float& value) {
  const float u1 = uniform_from_bits(w1);
  const float u2 = uniform_from_bits(w2);
  const float x = sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2);
  const float t = 1.0f + c * x;
  const float v = t * (t * t);
  const float u = uniform_from_bits(w3);
  const float rhs = 0.5f * x * x + d - d * v + d * logf(v > 0.0f ? v : 1.0f);
  const bool ok = v > 0.0f && logf(u) < rhs;
  if (ok) value = d * v;
  return ok;
}

// Word w of a Philox block, by selects (an indexed struct would live in local memory).
__device__ __forceinline__ uint32_t word(const Philox4& b, uint32_t w) {
  return w == 0u ? b.x[0] : w == 1u ? b.x[1] : w == 2u ? b.x[2] : b.x[3];
}

// The boost of a shape a < 1 by the uniform of site 18.
__device__ __forceinline__ float boosted(float value, float a, uint32_t w) {
  return value * powf(uniform_from_bits(w), 1.0f / a);
}

__global__ void __launch_bounds__(kThreads) gamma_kernel(uint32_t seed, long long n, const float* __restrict__ a,
                                                          float* __restrict__ out) {
  __shared__ int queue[kTile];  // tile offsets of the draws that missed round 0
  __shared__ int queued;
  const long long tiles = (n + kTile - 1) / kTile;
  const bool vec = (((uintptr_t)a | (uintptr_t)out) & 15u) == 0;  // 16-byte loads and stores
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if (threadIdx.x == 0) queued = 0;
    __syncthreads();
    const long long g = tile * kThreads + threadIdx.x;  // this thread's group of four
    const long long base = 4 * g;
    if (base < n) {
      const bool full = base + 4 <= n;
      float av[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (full && vec) {
        const float4 q = *reinterpret_cast<const float4*>(a + base);
        av[0] = q.x;
        av[1] = q.y;
        av[2] = q.z;
        av[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) av[e] = base + e < n ? a[base + e] : 1.0f;
      }
      const uint32_t j4 = (uint32_t)g;
      const Philox4 b1 = site_block(seed, 0u, 0u, 0u, j4);
      const Philox4 b2 = site_block(seed, 0u, 0u, 1u, j4);
      const Philox4 b3 = site_block(seed, 0u, 0u, 2u, j4);
      float value[4];
      bool ok[4], need_boost = false;
      int missed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float d, c;
        mt_shape(av[e], d, c);
        value[e] = d;
        ok[e] = mt_round(d, c, b1.x[e], b2.x[e], b3.x[e], value[e]) && base + e < n;
        need_boost = need_boost || (ok[e] && av[e] < 1.0f);
        missed += (!ok[e] && base + e < n) ? 1 : 0;
      }
      if (need_boost) {
        const Philox4 bb = site_block(seed, 0u, 0u, (uint32_t)(3 * kRounds), j4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok[e] && av[e] < 1.0f) value[e] = boosted(value[e], av[e], bb.x[e]);
        }
      }
      if (missed == 0 && full && vec) {
        *reinterpret_cast<float4*>(out + base) = make_float4(value[0], value[1], value[2], value[3]);
      } else {
        int slot = missed > 0 ? atomicAdd(&queued, missed) : 0;
        const int offset = 4 * threadIdx.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (base + e >= n) continue;
          if (ok[e]) out[base + e] = value[e];
          else queue[slot++] = offset + e;
        }
      }
    }
    __syncthreads();
    const int count = queued;
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const long long j = tile * kTile + queue[i];
      const uint32_t j4 = (uint32_t)(j / 4), w = (uint32_t)(j % 4);
      const float aj = a[j];
      float d, c;
      mt_shape(aj, d, c);
      float value = d;
#pragma unroll 1
      for (int r = 1; r < kRounds; ++r) {
        const uint32_t w1 = word(site_block(seed, 0u, 0u, (uint32_t)(3 * r), j4), w);
        const uint32_t w2 = word(site_block(seed, 0u, 0u, (uint32_t)(3 * r + 1), j4), w);
        const uint32_t w3 = word(site_block(seed, 0u, 0u, (uint32_t)(3 * r + 2), j4), w);
        if (mt_round(d, c, w1, w2, w3, value)) break;
      }
      if (aj < 1.0f) value = boosted(value, aj, word(site_block(seed, 0u, 0u, (uint32_t)(3 * kRounds), j4), w));
      out[j] = value;
    }
    __syncthreads();  // the queue is reused by the next tile
  }
}

extern "C" int gamma_launch(uint32_t seed, long long n, const float* a, float* out, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  long long blocks = tiles;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  gamma_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(seed, n, a, out);
  return (int)cudaGetLastError();
}
