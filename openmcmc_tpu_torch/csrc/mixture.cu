// mixture: the whole Gaussian-mixture Gibbs run, every sweep for every chain in
// one launch, K <= 32 components, n <= 2^20 points.
//
// Replaces the TPU kernel openmcmc_tpu/fused/mixture.py:_make_kernel (pallas_call
// at mixture.py:436). Model: y_ij ~ N(mu_{Z_i}, 1/lam_{Z_i}), Z_i ~ Cat(w_i.),
// mu ~ N(mu0, diag(p0)^-1), lam_k ~ Gamma(a0_k, b0_k); the data enter as the
// packed columns [count | sum | sum of squares | log w_1..K] (n4 floats each).
// One sweep per chain is
//   allocation: per point the K log-likelihoods
//     ll_k = log w_k + cnt/2 (log lam_k - log 2 pi) - lam_k/2 (sq - 2 mu_k sum + cnt mu_k^2),
//     w_k = exp(ll_k - max ll), one uniform u, zidx = #{k < K-1 : u sum w >= cum_k};
//     S0..S3 per component = sums of cnt, sum, sq, log w over the allocated points
//   means: a joint (truncated) random-walk step with one accept, or the
//     conjugate draw q = p0 + lam S0, mu = (p0 mu0 + lam S1) / q + z / sqrt(q)
//   precisions: lam_k ~ Gamma(a0 + S0/2, b0 + quad/2), quad = S2 - 2 mu S1 + S0 mu^2
//     (gamma_mt_elem, prng.cuh)
//   the log posterior at the end-of-sweep state, stored with mu and lam (and the
//     allocation, on request) every stored sweep
// every step in the JAX kernel's operation order (compiled with --fmad=false,
// like the plain version in openmcmc_tpu_torch/fused/mixture.py).
//
// Bits: Philox4x32-10 (philox.cuh), key (seed, 0), counter (chain, sweep, site,
// j / 4), word j % 4. Site 0 holds the n allocation uniforms (j = point); the
// random walk's site 1 the K proposal normals (or truncated-draw uniforms) and
// site 2 the accept uniform; the conjugate means' site 1 the K normals; then the
// six Gamma rounds, a (normal, uniform) pair of sites over K each.
//
// Summation order (the plain version's): T logical threads a chain (T a power
// of two in [32, 256], set by the host from n); logical thread t adds the
// points 4 (r T + t) + j, r and then j ascending, into its own partial sums;
// the T partials then meet in a halving tree, x[t] += x[t + h] for h = T/2 ..
// 1 (quad cancels, and the sums feed discrete allocations).
//
// Design: a physical thread runs M logical threads (t = its index within the
// chain + 32 W m). A logical thread loads a group's four points of every
// column as one 16-byte word (a warp reads 512 contiguous bytes a column), keeps
// the group's K log weights in registers for the S3 term, and adds each point's
// (cnt, sum, sq, log w) to its component's float4 of partials, [K][T] in
// shared memory, in one 16-byte read-modify-write at its own slot. Two layouts,
// by n and K:
//   W = 1 (T = 32, or T = 64 with K <= 8): a warp per chain, four chains a
//     block; after the pass a lane loads its M logical threads' partials, the
//     tree's levels h >= 32 are in-lane adds, the last five __shfl_down_sync,
//     and the whole sweep synchronises with __syncwarp only;
//   W = T / 32 (otherwise): a block of T threads per chain, M = 1; the partials
//     meet in the halving tree in shared memory.
// Then thread k < K updates component k; the random walk's accept and the log
// posterior are summed over k by thread 0 in the JAX kernel's order. The
// component constants (mu, log lam - log 2 pi, lam / 2, 2 mu) are one 16-byte
// shared load a component.
//
// What bounds it on an H100: at n = 10^5 the allocation pass, about 30 issued
// instructions and one expf per point and component over 256 chains, plus the
// 7.6 MB of data columns read through L2 by every chain each sweep; at n = 200
// the length of the sweep's serial path on one warp (the component step, the
// Gamma rounds and the two sums over k), with 31 chains a SM to hide it.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct MixParams {
  uint32_t seed;
  int32_t n_chains;
  int32_t n;         // points
  int32_t n4;        // row stride of the data columns: n rounded up to 4
  int32_t k;         // components
  int32_t threads;   // T
  int32_t n_sweeps;  // n_burn + n_keep * n_thin
  int32_t n_burn;    // burn-in SWEEPS
  int32_t n_thin;
  int32_t n_keep;
  int32_t conjugate;   // conjugate means instead of the random walk
  int32_t has_domain;  // truncated random-walk proposals on [lb, ub]
  int32_t store_z;     // store each stored sweep's allocation
  float step;
};

static constexpr int kMaxK = 32;
static constexpr int kWarpChains = 4;  // chains a block in the warp-per-chain layout
static constexpr unsigned kFull = 0xffffffffu;
static constexpr float kLog2Pi = 1.83787706640934534f;

struct ChainState {  // a chain's component state and the sweep's per-component values
  float4 cst[kMaxK];  // mu, log lam - log 2 pi, lam / 2, 2 mu: the allocation's constants
  float mu[kMaxK], lam[kMaxK];
  float4 stats[kMaxK];  // S0..S3 of each component
  float prop[kMaxK], rev[kMaxK], fwd[kMaxK], lik[kMaxK], pri[kMaxK];
  float lp[8][kMaxK];
  int accept;
};

__device__ __forceinline__ float elem(const float4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_down4(const float4& v, int h) {
  return make_float4(__shfl_down_sync(kFull, v.x, h), __shfl_down_sync(kFull, v.y, h),
                     __shfl_down_sync(kFull, v.z, h), __shfl_down_sync(kFull, v.w, h));
}

__device__ __forceinline__ void set_component(ChainState& cs, int k, float mu, float lam, float log_lam) {
  cs.mu[k] = mu;
  cs.lam[k] = lam;
  cs.cst[k] = make_float4(mu, log_lam - kLog2Pi, 0.5f * lam, 2.0f * mu);
}

template <int KB, int M>
__global__ void __launch_bounds__(256, 2)
    mixture_kernel(MixParams prm, const float* __restrict__ scal, const float* __restrict__ data,
                   float* __restrict__ out_means, float* __restrict__ out_lams, float* __restrict__ out_lp,
                   float* __restrict__ out_acc, int* __restrict__ out_z) {
  extern __shared__ float4 s_part[];  // [chains][K][T]: each logical thread's (S0, S1, S2, S3) partials
  __shared__ ChainState s_chain[kWarpChains];

  const int K = prm.k, T = prm.threads, n = prm.n, n4 = prm.n4;
  const int W = T / (32 * M);  // warps a chain
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pt = W == 1 ? lane : (int)threadIdx.x;  // the thread's index within its chain
  const uint32_t chain = W == 1 ? blockIdx.x * kWarpChains + warp : blockIdx.x;
  if ((int)chain >= prm.n_chains) return;  // a whole warp of the warp-per-chain layout
  ChainState& cs = s_chain[W == 1 ? warp : 0];
  float4* part = s_part + (W == 1 ? warp : 0) * K * T;
  const auto sync = [W] {
    if (W == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  };
  const uint32_t seed = prm.seed;
  const float *mu0 = scal, *p0 = scal + K, *a0 = scal + 2 * K, *b0 = scal + 3 * K;
  const float *lb = scal + 6 * K, *ub = scal + 7 * K, *lgam = scal + 8 * K;
  if (pt < K) {
    const float lam = 0.0f + scal[5 * K + pt];
    set_component(cs, pt, 0.0f + scal[4 * K + pt], lam, logf(lam));
  }
  float acc_total = 0.0f;
  sync();
  const int groups = (n + 3) / 4, n4q = n4 / 4;
  const float4* d4 = reinterpret_cast<const float4*>(data);  // column c, group g at d4[c n4 / 4 + g]

  for (int it = 0; it < prm.n_sweeps; ++it) {
    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    int* oz = prm.store_z && idx >= 0 ? out_z + ((size_t)chain * prm.n_keep + idx) * n : nullptr;

    // ---- allocation: each logical thread's points in ascending order, a group
    // of four points' columns loaded as one 16-byte word each
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int t = pt + 32 * W * m;
      for (int k = 0; k < K; ++k) part[k * T + t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int g = t; g < groups; g += T) {
        const Philox4 blk = site_block(seed, chain, (uint32_t)it, 0u, (uint32_t)g);
        const float4 cnt4 = __ldg(d4 + g), sm4 = __ldg(d4 + n4q + g), sq4 = __ldg(d4 + 2 * n4q + g);
        float4 lw4[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) lw4[k] = __ldg(d4 + (3 + k) * n4q + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * g + j;
          if (i < n) {
            const float cnt = elem(cnt4, j), sm = elem(sm4, j), sq = elem(sq4, j);
            const float hc = 0.5f * cnt;
            float w[KB];
            float mx = 0.0f;
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              if (k < K) {
                const float4 c = cs.cst[k];
                w[k] = (elem(lw4[k], j) + hc * c.y) - c.z * ((sq - c.w * sm) + (cnt * c.x) * c.x);
                mx = k == 0 ? w[0] : fmaxf(mx, w[k]);
              }
            }
            float tot = 0.0f;
#pragma unroll
            for (int k = 0; k < KB; ++k) {
              if (k < K) {
                w[k] = expf(w[k] - mx);
                tot = k == 0 ? w[0] : tot + w[k];
              }
            }
            const float u = uniform_from_bits(blk.x[j]) * tot;
            float cum = w[0];
            int z = u >= cum ? 1 : 0;
#pragma unroll
            for (int k = 1; k < KB - 1; ++k) {
              if (k < K - 1) {
                cum = cum + w[k];
                z += u >= cum ? 1 : 0;
              }
            }
            float lwz = 0.0f;
#pragma unroll
            for (int k = 0; k < KB; ++k)
              if (z == k) lwz = elem(lw4[k], j);
            float4* a = part + z * T + t;
            float4 v = *a;
            v.x += cnt;
            v.y += sm;
            v.z += sq;
            v.w += lwz;
            *a = v;
            if (oz) oz[i] = z;
          }
        }
      }
    }

    // ---- the halving tree over the T logical threads: x[t] += x[t + h]
    if (W == 1) {  // levels h >= 32 in each lane, then the last five by shuffles
      float4 acc[M][KB];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) acc[m][k] = part[k * T + pt + 32 * m];
#pragma unroll
      for (int hm = M / 2; hm >= 1; hm /= 2)  // h = 32 hm
#pragma unroll
        for (int m = 0; m < hm; ++m)
#pragma unroll
          for (int k = 0; k < KB; ++k)
            if (k < K) acc[m][k] = add4(acc[m][k], acc[m + hm][k]);
#pragma unroll
      for (int h = 16; h >= 1; h /= 2)
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) acc[0][k] = add4(acc[0][k], shfl_down4(acc[0][k], h));
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k < K) cs.stats[k] = acc[0][k];
      }
    } else {
      __syncthreads();
      for (int h = T / 2; h >= 1; h >>= 1) {
        for (int e = pt; e < K * h; e += T) {
          const int k = e / h, tt = e - k * h;
          part[k * T + tt] = add4(part[k * T + tt], part[k * T + tt + h]);
        }
        __syncthreads();
      }
      if (pt < K) cs.stats[pt] = part[pt * T];
    }
    sync();

    // ---- means
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, mu_new = 0.0f;
    if (pt < K) {
      const float4 st = cs.stats[pt];
      s0 = st.x;
      s1 = st.y;
      s2 = st.z;
      s3 = st.w;
      const float mu = cs.mu[pt], lam = cs.lam[pt];
      const uint32_t bits = site_block(seed, chain, (uint32_t)it, 1u, (uint32_t)pt / 4u).x[pt % 4];
      if (prm.conjugate) {
        const float q = p0[pt] + lam * s0;
        const float post_mean = (p0[pt] * mu0[pt] + lam * s1) / q;
        mu_new = post_mean + normal_icdf_from_bits(bits) * (1.0f / sqrtf(q));
      } else {
        const float step = prm.step;
        float z;
        if (prm.has_domain) {
          z = truncnorm_from_bits(mu, step, lb[pt], ub[pt], bits);
          cs.rev[pt] = truncnorm_logpdf(mu, z, step, lb[pt], ub[pt]);
          cs.fwd[pt] = truncnorm_logpdf(z, mu, step, lb[pt], ub[pt]);
        } else {
          z = mu + step * normal_icdf_from_bits(bits);
        }
        const float quad_cur = s2 - 2.0f * mu * s1 + s0 * mu * mu;
        const float quad_prop = s2 - 2.0f * z * s1 + s0 * z * z;
        const float dm = mu - mu0[pt], dz = z - mu0[pt];
        cs.prop[pt] = z;
        cs.lik[pt] = 0.5f * lam * (quad_cur - quad_prop);
        cs.pri[pt] = 0.5f * p0[pt] * (dm * dm - dz * dz);
      }
    }
    if (!prm.conjugate) {
      sync();
      if (pt == 0) {
        float delta = 0.0f;
        for (int k = 0; k < K; ++k) {
          if (prm.has_domain) {
            delta = delta + cs.rev[k];
            delta = delta - cs.fwd[k];
          }
          delta = delta + cs.lik[k];
          delta = delta + cs.pri[k];
        }
        const float u = uniform_from_bits(site_block(seed, chain, (uint32_t)it, 2u, 0u).x[0]);
        const bool accept = logf(u) < delta;
        acc_total = acc_total + (accept ? 1.0f : 0.0f);
        cs.accept = accept ? 1 : 0;
      }
      sync();
      if (pt < K) mu_new = cs.accept ? cs.prop[pt] : cs.mu[pt];
    }

    // ---- precisions and the log-posterior terms of component pt
    if (pt < K) {
      const float quad = s2 - 2.0f * mu_new * s1 + s0 * mu_new * mu_new;
      const uint32_t site0 = prm.conjugate ? 2u : 3u;
      const float lam_new =
          gamma_mt_elem(a0[pt] + 0.5f * s0, b0[pt] + 0.5f * quad, seed, chain, (uint32_t)it, site0, (uint32_t)pt);
      const float log_lam = logf(lam_new);
      const float dm = mu_new - mu0[pt];
      cs.lp[0][pt] = 0.5f * s0 * (log_lam - kLog2Pi);
      cs.lp[1][pt] = 0.5f * lam_new * quad;
      cs.lp[2][pt] = s3;
      cs.lp[3][pt] = 0.5f * (logf(p0[pt]) - kLog2Pi);
      cs.lp[4][pt] = 0.5f * p0[pt] * (dm * dm);
      cs.lp[5][pt] = lgam[pt];
      cs.lp[6][pt] = (a0[pt] - 1.0f) * log_lam;
      cs.lp[7][pt] = b0[pt] * lam_new;
      set_component(cs, pt, mu_new, lam_new, log_lam);
      if (idx >= 0) {
        const size_t o = ((size_t)chain * prm.n_keep + idx) * K + pt;
        out_means[o] = mu_new;
        out_lams[o] = lam_new;
      }
    }
    sync();
    if (pt == 0 && idx >= 0) {
      float lp = 0.0f;
      for (int k = 0; k < K; ++k) {
        lp = lp + cs.lp[0][k];
        lp = lp - cs.lp[1][k];
        lp = lp + cs.lp[2][k];
        lp = lp + cs.lp[3][k];
        lp = lp - cs.lp[4][k];
        lp = lp + cs.lp[5][k];
        lp = lp + cs.lp[6][k];
        lp = lp - cs.lp[7][k];
      }
      out_lp[(size_t)chain * prm.n_keep + idx] = lp;
    }
  }
  if (pt == 0) out_acc[chain] = acc_total;
}

template <int KB, int M>
static int launch(const MixParams& prm, const float* scal, const float* data, float* out_means, float* out_lams,
                  float* out_lp, float* out_acc, int* out_z, cudaStream_t stream) {
  const int w = prm.threads / (32 * M);
  int blocks = prm.n_chains, threads = prm.threads, smem = prm.k * prm.threads * (int)sizeof(float4);
  if (w == 1) {
    blocks = (prm.n_chains + kWarpChains - 1) / kWarpChains;
    threads = 32 * kWarpChains;
    smem *= kWarpChains;
  }
  cudaError_t err = cudaFuncSetAttribute(mixture_kernel<KB, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mixture_kernel<KB, M><<<blocks, threads, smem, stream>>>(prm, scal, data, out_means, out_lams, out_lp, out_acc,
                                                            out_z);
  return (int)cudaGetLastError();
}

extern "C" int mixture_launch(const MixParams* prm, const float* scal, const float* data, float* out_means,
                              float* out_lams, float* out_lp, float* out_acc, int* out_z, cudaStream_t stream) {
  const int t = prm->threads;
  if (prm->k < 1 || prm->k > kMaxK || prm->n < 1 || prm->n4 < prm->n || prm->n4 % 4 != 0 ||
      (t != 32 && t != 64 && t != 128 && t != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  // a warp per chain (two logical threads a lane at T = 64) while its partials fit 64 registers
  const bool two = t == 64 && prm->k <= 8;
  if (prm->k <= 2) {
    return two ? launch<2, 2>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream)
               : launch<2, 1>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  }
  if (prm->k <= 4) {
    return two ? launch<4, 2>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream)
               : launch<4, 1>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  }
  if (prm->k <= 8) {
    return two ? launch<8, 2>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream)
               : launch<8, 1>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  }
  if (prm->k <= 16) return launch<16, 1>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  return launch<32, 1>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
}
