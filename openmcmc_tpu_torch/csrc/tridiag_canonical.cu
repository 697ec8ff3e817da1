// tridiag_canonical: one canonical Gaussian draw x ~ N(Q^-1 b, Q^-1) per chain,
// Q tridiagonal (Rue & Held Alg. 2.5), the NormalNormal step of the generic
// driver on a GMRF smoother.
//
// Replaces the TPU kernel openmcmc_tpu/linalg/pallas_tridiag.py:_kernel
// (pallas_call at pallas_tridiag.py:134). Per chain, with a the diagonal, c the
// super-diagonal (c_{p-1} unused) and b the canonical mean:
//   ld_i = sqrt(a_i - (c_{i-1} / ld_{i-1})^2),  w_i = (b_i - l_{i-1} w_{i-1}) / ld_i
//   u_i  = w_i + z_i,  z_i = sqrt(-2 log u1) cos(2 pi u2)   (Box-Muller, cos branch)
//   x_i  = (u_i - (c_i / ld_i) x_{i+1}) / ld_i,  x_p = 0
// in the JAX kernel's operation order; no pivot clamp (the TPU kernel has none,
// and a conditional precision with a positive likelihood diagonal never needs
// it). The uniforms are u1 = (i24 + 1) 2^-24 and u2 = i24 2^-24 from the top 24
// bits of Philox4x32-10 (philox.cuh): key (seed, 0), counter
// (chain, call, site, i / 4), word i % 4, site 0 for u1 and site 1 for u2. The
// call counter is the host's count of draws in the run, so the stream does not
// depend on the launch geometry.
//
// Design: one thread per chain. The wrapper hands the bands and b over in a
// (p, chains) layout, so consecutive threads read and write consecutive
// addresses on every row; ld and u go to scratch in the same layout, and the
// back substitution reads them again. The output x is (p, chains) too.
//
// What bounds it: at the main path's shape (8192 chains, p = 100) the call reads
// a, c, b and writes x, 13.1 MB (3.9 us at 3.35 TB/s), and does about 50 FLOP per
// element (4e7, negligible). Each chain is a chain of 2p dependent IEEE divisions
// and square roots, and 8192 chains are about 2 warps per SM: the kernel is
// bound by that latency, not by memory or arithmetic rate.
#include <cuda_runtime.h>

#include "philox.cuh"

struct TridiagParams {
  uint32_t seed;
  uint32_t call;
  int32_t n_chains;
  int32_t p;
};

static constexpr int kThreads = 64;  // 8192 chains -> 128 blocks, about one per SM

__global__ void tridiag_canonical_kernel(TridiagParams prm, const float* __restrict__ a,
                                         const float* __restrict__ c, const float* __restrict__ b,
                                         float* __restrict__ x, float* __restrict__ ld,
                                         float* __restrict__ u) {
  const int chain = blockIdx.x * blockDim.x + threadIdx.x;
  if (chain >= prm.n_chains) return;
  const size_t stride = (size_t)prm.n_chains;
  const int p = prm.p;

  // forward: Thomas factor and solve, plus the noise
  float ld_prev = 1.0f, w_prev = 0.0f, c_prev = 0.0f;
  for (int g = 0; 4 * g < p; ++g) {
    Philox4 bits1 = site_block(prm.seed, (uint32_t)chain, prm.call, 0u, (uint32_t)g);
    Philox4 bits2 = site_block(prm.seed, (uint32_t)chain, prm.call, 1u, (uint32_t)g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e;
      if (i < p) {
        const size_t o = (size_t)i * stride + chain;
        const float u1 = ((float)(bits1.x[e] >> 8) + 1.0f) * (1.0f / 16777216.0f);
        const float u2 = (float)(bits2.x[e] >> 8) * (1.0f / 16777216.0f);
        const float z = sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2);
        const float l_prev = c_prev / ld_prev;
        const float ld_i = sqrtf(a[o] - l_prev * l_prev);
        const float w = (b[o] - l_prev * w_prev) / ld_i;
        ld[o] = ld_i;
        u[o] = w + z;
        ld_prev = ld_i;
        w_prev = w;
        c_prev = c[o];
      }
    }
  }

  // backward: x = L^-T u
  float x_next = 0.0f;
  for (int i = p - 1; i >= 0; --i) {
    const size_t o = (size_t)i * stride + chain;
    const float ld_i = ld[o];
    x_next = (u[o] - (c[o] / ld_i) * x_next) / ld_i;
    x[o] = x_next;
  }
}

extern "C" int tridiag_canonical_launch(const TridiagParams* prm, const float* a, const float* c,
                                        const float* b, float* x, float* ld, float* u,
                                        cudaStream_t stream) {
  const int blocks = (prm->n_chains + kThreads - 1) / kThreads;
  tridiag_canonical_kernel<<<blocks, kThreads, 0, stream>>>(*prm, a, c, b, x, ld, u);
  return (int)cudaGetLastError();
}
