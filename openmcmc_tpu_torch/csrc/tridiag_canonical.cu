// tridiag_canonical: one canonical Gaussian draw x ~ N(Q^-1 b, Q^-1) per chain,
// Q tridiagonal (Rue & Held Alg. 2.5), the NormalNormal step of the generic
// driver on a GMRF smoother.
//
// Replaces the TPU kernel openmcmc_tpu/linalg/pallas_tridiag.py:_kernel
// (pallas_call at pallas_tridiag.py:134). Per chain, with a the diagonal, c the
// super-diagonal (c_{p-1} unused) and b the canonical mean:
//   l_i = c_{i-1} / ld_{i-1},  ld_i = sqrt(a_i - l_i^2),  w_i = (b_i - l_i w_{i-1}) / ld_i
//   u_i  = w_i + z_i,  z_i = sqrt(-2 log u1) cos(2 pi u2)   (Box-Muller, cos branch)
//   x_i  = (u_i - (c_i / ld_i) x_{i+1}) / ld_i,  x_p = 0
// in the JAX kernel's operation order (compiled with --fmad=false, like the plain
// version in openmcmc_tpu_torch/linalg/tridiag.py); no pivot clamp (the TPU
// kernel has none, and a conditional precision with a positive likelihood
// diagonal never needs it). The uniforms are u1 = (i24 + 1) 2^-24 and
// u2 = i24 2^-24 from the top 24 bits of Philox4x32-10 (philox.cuh): key
// (seed, 0), counter (chain, call, site, i / 4), word i % 4, site 0 for u1 and
// site 1 for u2. The call counter is the host's count of draws in the run, so
// the stream does not depend on the launch geometry.
//
// Layout: a, c and b are read as the caller holds them, (chains, p) rows with
// contiguous columns and a row stride each (the band rows of a batched Banded
// need no copy); x is written as a contiguous (chains, p) tensor.
//
// Design: K4's Thomas design (gmrf_smoother.cu), on per-chain rows. A block
// serves 32 chains with one consumer warp (lane = chain) and seven producer
// warps, through a ring of 128-row tiles in shared memory, one barrier per
// tile; a slot holds six arrays [row][33] (A, C, B, L, LD, W), so a warp reads
// a row across its chains (the consumer, the certificates) or a chain across
// its rows (the staging of a, c, b and the store of x) without a bank conflict.
//   forward  producers: a, c_{i-1} and b staged by cp.async a tile ahead (no
//                       registers held), the Box-Muller noise of the tile the
//                       consumer is on, and a tile behind it the certificates of
//                       the consumer's l, ld, w; then the back pass's row
//                       (ld, u = w + z, coef = c_i / ld by IEEE division, an
//                       approximate 1 / ld) in place of a, b and l;
//            consumer:  l, ld, w (thomas.cuh forward_row), nothing else;
//   back     producers: tiles that left the ring restaged from the per-block
//                       global scratch by cp.async, the certificates of x a tile
//                       behind, then x stored, a chain's rows contiguous;
//            consumer:  x (thomas.cuh back_row) into W.
// The last two tiles stay in the ring from the forward pass to the back pass,
// so at p <= 256 nothing goes through global scratch, and at p <= 128 a block
// needs one slot (92 KB at p = 100: two blocks an SM). The consumer's divisions
// and square roots are branch-free and certified (thomas.cuh); a block with a
// failed certificate reruns both passes with the IEEE operators, so every value
// is the IEEE one, as the plain version computes it.
//
// What bounds it: at the main path's shape (8192 chains, p = 100) the call reads
// a, c, b and writes x, 13.1 MB (3.9 us at 3.35 TB/s), and does about 21 FLOP
// per element (1.7e7, negligible). Each chain is a chain of 2p dependent steps
// (the forward row's division, square root and division, the back row's
// division): the kernel is bound by the consumer warp's latency per row, with
// all 256 blocks resident at once at that shape.
#include <cuda_runtime.h>

#include "philox.cuh"
#include "thomas.cuh"

struct TridiagParams {
  uint32_t seed;
  uint32_t call;
  int32_t n_chains;
  int32_t p;
  int64_t sa;  // row strides (elements) of a, c and b; columns are contiguous
  int64_t sc;
  int64_t sb;
  int32_t slot_rows;  // rows of a ring slot: min(p, kTile)
  int32_t n_slots;    // 1 when one tile holds the chain, else 2
};

static constexpr int kChains = 32;    // chains per block: the consumer warp's lanes
static constexpr int kProducers = 7;  // warps 1-7; warp 0 is the consumer
static constexpr int kProducerThreads = 32 * kProducers;
static constexpr int kTile = 128;     // rows per tile of the ring
static constexpr int kStep = 8;       // rows the consumer loads ahead of its dependent steps
static constexpr int kPitch = kChains + 1;
static constexpr int kArrays = 6;     // A, C, B, L, LD, W
enum { kA, kC, kB, kL, kLD, kW };
// the back pass's row in the ring: ld in LD, u in B, c_i / ld in A, ~1 / ld in L;
// x goes into W
static_assert(kTile % kStep == 0 && kTile % 4 == 0, "a tile holds whole Philox groups and consumer steps");

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducerThreads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__global__ void __launch_bounds__(32 * (1 + kProducers), 2)
    tridiag_canonical_kernel(TridiagParams prm, const float* __restrict__ a, const float* __restrict__ c,
                             const float* __restrict__ b, float* __restrict__ x, float* __restrict__ scratch) {
  extern __shared__ float smem[];  // [n_slots][kArrays][slot_rows][kPitch], then Z [slot_rows][kPitch]
  __shared__ float2 carry[2][kChains];  // the consumer's state before each tile's first (forward) or last row

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool consumer = warp == 0;
  const int q = warp - 1;  // producer index
  const int chain0 = blockIdx.x * kChains, chain = chain0 + lane;
  const bool live = chain < prm.n_chains;
  const int p = prm.p, n_tiles = (p + kTile - 1) / kTile, n_ev = n_tiles > 2 ? n_tiles - 2 : 0;
  const int R = prm.slot_rows;
  const size_t arr = (size_t)R * kPitch;
  float* zs = smem + (size_t)prm.n_slots * kArrays * arr;
  const auto slot = [&](int t, int k) { return smem + ((size_t)(t & 1) * kArrays + k) * arr; };
  // tile t's row r, component k (ld, u, coef, ~1 / ld), in this block's global scratch (t < n_ev)
  const auto spill = [&](int t, int k, int r) {
    return scratch + ((((size_t)blockIdx.x * n_ev + t) * 4 + k) * kTile + r) * kChains;
  };
  const int spill_array[4] = {kLD, kB, kA, kL};

  // ---- forward: the factor and the solve; the noise and the back pass's rows
  const auto forward = [&](auto ex) {
    bool ok = true;
    Fwd st{0.0f, 1.0f, 1.0f, 0.0f};
    for (int s = -1; s <= n_tiles; ++s) {
      if (consumer) {
        if (s >= 0 && s < n_tiles) {
          const int rows = min(kTile, p - s * kTile);
          const float *A = slot(s, kA), *C = slot(s, kC), *B = slot(s, kB);
          float *L = slot(s, kL), *LD = slot(s, kLD), *W = slot(s, kW);
          carry[s & 1][lane] = make_float2(st.ld, st.w);
          for (int r0 = 0; r0 < rows; r0 += kStep) {
            float3 v[kStep];
#pragma unroll
            for (int k = 0; k < kStep; ++k) {
              const int o = (r0 + k) * kPitch + lane;
              v[k] = r0 + k < rows ? make_float3(A[o], C[o], B[o]) : float3{};
            }
#pragma unroll
            for (int k = 0; k < kStep; ++k) {
              if (r0 + k < rows) {
                st = forward_row(ex, st, v[k].y, v[k].x, v[k].z);
                const int o = (r0 + k) * kPitch + lane;
                L[o] = st.l;
                LD[o] = st.ld;
                W[o] = st.w;
              }
            }
          }
        }
      } else {
        if (s >= 1) {  // tile t = s - 1: certify the consumer's results, then lay out the back pass's rows
          const int t = s - 1, i0 = t * kTile, rows = min(kTile, p - i0);
          float *A = slot(t, kA), *C = slot(t, kC), *B = slot(t, kB), *L = slot(t, kL), *LD = slot(t, kLD),
                *W = slot(t, kW);
          // c at the tile's last row: the next tile's first c_{i-1}, or c_{p-1} itself
          const float c_last =
              t + 1 < n_tiles ? slot(t + 1, kC)[lane] : (live ? __ldg(c + (size_t)chain * prm.sc + p - 1) : 0.0f);
          for (int r = q; r < rows; r += kProducers) {
            const int o = r * kPitch + lane;
            const float l = L[o], ld = LD[o], w = W[o];
            const float2 prev = r > 0 ? make_float2(LD[o - kPitch], W[o - kPitch]) : carry[t & 1][lane];
            if (!is_exact(ex) && live) {
              const float av = A[o], cp = C[o], rhs = B[o];
              ok = ok && (i0 + r == 0 || div_certified(cp, prev.x, l)) && sqrt_certified(av - l * l, ld) &&
                   div_certified(rhs - l * prev.y, ld, w);
            }
            const float ci = r + 1 < rows ? C[o + kPitch] : c_last;
            const float coef = ci / ld, y = refine_rcp(ld, approx_rcp(ld)), u = w + zs[o];
            A[o] = coef;
            B[o] = u;
            L[o] = y;
            if (t < n_ev) {
              spill(t, 0, r)[lane] = ld;
              spill(t, 1, r)[lane] = u;
              spill(t, 2, r)[lane] = coef;
              spill(t, 3, r)[lane] = y;
            }
          }
          producers_sync();  // the slot and Z are free again
        }
        if (s + 1 < n_tiles) {  // stage tile s + 1: a chain's rows across the lanes
          const int t = s + 1, i0 = t * kTile, rows = min(kTile, p - i0);
          float *A = slot(t, kA), *C = slot(t, kC), *B = slot(t, kB);
          for (int k = q; k < kChains; k += kProducers) {
            const int ch = chain0 + k;
            const float *ra = a + (size_t)ch * prm.sa, *rc = c + (size_t)ch * prm.sc, *rb = b + (size_t)ch * prm.sb;
            for (int r = lane; r < rows; r += 32) {
              const int o = r * kPitch + k, i = i0 + r;
              if (ch < prm.n_chains) {
                cp_async4(A + o, ra + i);
                cp_async4(B + o, rb + i);
                if (i > 0) {
                  cp_async4(C + o, rc + i - 1);
                } else {
                  C[o] = 0.0f;
                }
              } else {  // a chain past the batch: a benign row
                A[o] = 1.0f;
                C[o] = 0.0f;
                B[o] = 0.0f;
              }
            }
          }
        }
        if (s >= 0 && s < n_tiles) {  // the noise of the consumer's tile, a Philox group at a time
          const int i0 = s * kTile, rows = min(kTile, p - i0);
          for (int g = q; 4 * g < rows; g += kProducers) {
            const Philox4 b1 = site_block(prm.seed, (uint32_t)chain, prm.call, 0u, (uint32_t)(i0 / 4 + g));
            const Philox4 b2 = site_block(prm.seed, (uint32_t)chain, prm.call, 1u, (uint32_t)(i0 / 4 + g));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * g + j < rows) {
                const float u1 = ((float)(b1.x[j] >> 8) + 1.0f) * (1.0f / 16777216.0f);
                const float u2 = (float)(b2.x[j] >> 8) * (1.0f / 16777216.0f);
                zs[(4 * g + j) * kPitch + lane] = sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958648f * u2);
              }
            }
          }
        }
        cp_async_wait_all();
      }
      __syncthreads();
    }
    return ok;
  };
  const bool exact = __syncthreads_or(!forward(Exact<false>{}));
  if (exact) forward(Exact<true>{});

  // ---- back substitution, descending tiles; item s is tile n_tiles - 1 - s
  const auto back = [&](auto ex) {
    bool ok = true;
    float x_next = 0.0f;
    for (int s = -1; s <= n_tiles; ++s) {
      if (consumer) {
        if (s >= 0 && s < n_tiles) {
          const int t = n_tiles - 1 - s, rows = min(kTile, p - t * kTile);
          const float *LD = slot(t, kLD), *U = slot(t, kB), *CF = slot(t, kA), *Y = slot(t, kL);
          float* X = slot(t, kW);
          carry[s & 1][lane].x = x_next;
          for (int r1 = rows - 1; r1 >= 0; r1 -= kStep) {
            float4 v[kStep];
#pragma unroll
            for (int k = 0; k < kStep; ++k) {
              const int o = (r1 - k) * kPitch + lane;
              v[k] = r1 - k >= 0 ? make_float4(LD[o], U[o], CF[o], Y[o]) : float4{};
            }
#pragma unroll
            for (int k = 0; k < kStep; ++k) {
              if (r1 - k >= 0) {
                x_next = back_row(ex, v[k], x_next);
                X[(r1 - k) * kPitch + lane] = x_next;
              }
            }
          }
        }
      } else {
        if (s >= 1) {  // tile t = item s - 1: certify x, then store it
          const int t = n_tiles - s, i0 = t * kTile, rows = min(kTile, p - i0);
          const float *LD = slot(t, kLD), *U = slot(t, kB), *CF = slot(t, kA), *X = slot(t, kW);
          if (!is_exact(ex) && live) {
            for (int r = q; r < rows; r += kProducers) {
              const int o = r * kPitch + lane;
              const float xn = r + 1 < rows ? X[o + kPitch] : carry[(s - 1) & 1][lane].x;
              ok = ok && div_certified(U[o] - CF[o] * xn, LD[o], X[o]);
            }
          }
          for (int k = q; k < kChains && chain0 + k < prm.n_chains; k += kProducers) {
            float* out = x + (size_t)(chain0 + k) * p + i0;
            for (int r = lane; r < rows; r += 32) out[r] = X[r * kPitch + k];
          }
          producers_sync();  // the slot is free again
        }
        const int t = n_tiles - 2 - s;  // item s + 1
        if (s + 1 < n_tiles && t < n_ev) {  // a tile that left the ring: restage it from the scratch
          const int rows = min(kTile, p - t * kTile);
          for (int r = q; r < rows; r += kProducers) {
#pragma unroll
            for (int k = 0; k < 4; ++k) cp_async4(slot(t, spill_array[k]) + r * kPitch + lane, spill(t, k, r) + lane);
          }
        }
        cp_async_wait_all();
      }
      __syncthreads();
    }
    return ok;
  };
  // the back pass runs exactly after an exact forward pass, and a failed one
  // redoes the forward pass too: its tiles have left the ring
  if (exact || __syncthreads_or(!back(Exact<false>{}))) {
    if (!exact) forward(Exact<true>{});
    back(Exact<true>{});
  }
}

extern "C" int tridiag_canonical_launch(const TridiagParams* prm, const float* a, const float* c,
                                        const float* b, float* x, float* scratch, cudaStream_t stream) {
  const TridiagParams& P = *prm;
  if (P.p < 1 || P.n_chains < 1 || P.slot_rows != (P.p < kTile ? P.p : kTile) ||
      P.n_slots != (P.p <= kTile ? 1 : 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = ((size_t)P.n_slots * kArrays + 1) * P.slot_rows * kPitch * sizeof(float);
  // the shared-memory limit is raised once per device to the most asked for (a
  // call a sweep on the generic path: the attribute call is host time)
  static int set_bytes[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || (int)smem > set_bytes[dev]) {
    err = cudaFuncSetAttribute(tridiag_canonical_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) set_bytes[dev] = (int)smem;
  }
  const int blocks = (P.n_chains + kChains - 1) / kChains;
  tridiag_canonical_kernel<<<blocks, 32 * (1 + kProducers), smem, stream>>>(P, a, c, b, x, scratch);
  return (int)cudaGetLastError();
}
