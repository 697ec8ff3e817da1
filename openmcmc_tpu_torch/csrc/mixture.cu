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
// Design: one block of T threads per chain (T a power of two in [32, 256], set
// by the host from n). Thread t walks the groups of four points g = t, t + T, ...
// in ascending order, one Philox block per group, and adds each point's (cnt,
// sum, sq, log w) into its own partial sums in shared memory ([4][K][T] floats);
// the T partials then meet in a halving tree in a fixed order, so that the plain
// version can add them in the same order (quad cancels, and the sums feed
// discrete allocations). The data columns are read through the read-only cache;
// the K log-likelihoods of a point live in registers (the kernel is templated on
// K rounded up to a power of two). Then thread k < K updates component k; the
// random walk's accept and the log posterior are summed over k by thread 0 in
// the JAX kernel's order.
//
// What bounds it on an H100: at n = 10^5 the allocation pass, about 20 float32
// operations and one expf per point and component, operations-bound; at n = 200
// the per-sweep latency of the block's barriers and of the single-thread sums
// (a few microseconds per sweep), which a warp per chain would shorten.
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
static constexpr float kLog2Pi = 1.83787706640934534f;

template <int KB>
__global__ void __launch_bounds__(256)
    mixture_kernel(MixParams prm, const float* __restrict__ scal, const float* __restrict__ data,
                   float* __restrict__ out_means, float* __restrict__ out_lams, float* __restrict__ out_lp,
                   float* __restrict__ out_acc, int* __restrict__ out_z) {
  extern __shared__ float s_part[];  // [4][K][T] partial sums
  __shared__ float c_mu[kMaxK], c_lam[kMaxK], c_cl[kMaxK], c_hlam[kMaxK], c_mu2[kMaxK];
  __shared__ float c_prop[kMaxK], c_rev[kMaxK], c_fwd[kMaxK], c_lik[kMaxK], c_pri[kMaxK];
  __shared__ float c_lp[8][kMaxK];
  __shared__ int s_accept;

  const int K = prm.k, T = prm.threads, t = threadIdx.x, n = prm.n, n4 = prm.n4;
  const uint32_t chain = blockIdx.x, seed = prm.seed;
  const float *mu0 = scal, *p0 = scal + K, *a0 = scal + 2 * K, *b0 = scal + 3 * K;
  const float *lb = scal + 6 * K, *ub = scal + 7 * K, *lgam = scal + 8 * K;
  if (t < K) {
    const float mu = 0.0f + scal[4 * K + t], lam = 0.0f + scal[5 * K + t];
    c_mu[t] = mu;
    c_lam[t] = lam;
    c_cl[t] = logf(lam) - kLog2Pi;
    c_hlam[t] = 0.5f * lam;
    c_mu2[t] = 2.0f * mu;
  }
  float acc = 0.0f;
  __syncthreads();
  const int groups = (n + 3) / 4;

  for (int it = 0; it < prm.n_sweeps; ++it) {
    const int idx = store_index(it, prm.n_burn, prm.n_thin);
    for (int qk = 0; qk < 4 * K; ++qk) s_part[qk * T + t] = 0.0f;

    // ---- allocation: each thread's points in ascending order
    for (int g = t; g < groups; g += T) {
      const Philox4 blk = site_block(seed, chain, (uint32_t)it, 0u, (uint32_t)g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * g + j;
        if (i < n) {
          const float cnt = __ldg(data + i), sm = __ldg(data + n4 + i), sq = __ldg(data + 2 * n4 + i);
          float w[KB];
          float m = 0.0f;
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k < K) {
              const float mu = c_mu[k];
              w[k] = __ldg(data + (3 + k) * n4 + i) + 0.5f * cnt * c_cl[k] -
                     c_hlam[k] * (sq - c_mu2[k] * sm + cnt * mu * mu);
              m = k == 0 ? w[0] : fmaxf(m, w[k]);
            }
          }
          float tot = 0.0f;
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            if (k < K) {
              w[k] = expf(w[k] - m);
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
          s_part[(0 * K + z) * T + t] += cnt;
          s_part[(1 * K + z) * T + t] += sm;
          s_part[(2 * K + z) * T + t] += sq;
          s_part[(3 * K + z) * T + t] += __ldg(data + (3 + z) * n4 + i);
          if (prm.store_z && idx >= 0) out_z[((size_t)chain * prm.n_keep + idx) * n + i] = z;
        }
      }
    }
    __syncthreads();
    // ---- the halving tree over the T partials: x[t] += x[t + h]
    for (int h = T / 2; h >= 1; h >>= 1) {
      for (int e = t; e < 4 * K * h; e += T) {
        const int qk = e / h, tt = e - qk * h;
        s_part[qk * T + tt] += s_part[qk * T + tt + h];
      }
      __syncthreads();
    }

    // ---- means
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, mu_new = 0.0f;
    if (t < K) {
      s0 = s_part[(0 * K + t) * T];
      s1 = s_part[(1 * K + t) * T];
      s2 = s_part[(2 * K + t) * T];
      s3 = s_part[(3 * K + t) * T];
      const float mu = c_mu[t], lam = c_lam[t];
      const uint32_t bits = site_block(seed, chain, (uint32_t)it, 1u, (uint32_t)t / 4u).x[t % 4];
      if (prm.conjugate) {
        const float q = p0[t] + lam * s0;
        const float post_mean = (p0[t] * mu0[t] + lam * s1) / q;
        mu_new = post_mean + normal_icdf_from_bits(bits) * (1.0f / sqrtf(q));
      } else {
        const float step = prm.step;
        float z;
        if (prm.has_domain) {
          z = truncnorm_from_bits(mu, step, lb[t], ub[t], bits);
          c_rev[t] = truncnorm_logpdf(mu, z, step, lb[t], ub[t]);
          c_fwd[t] = truncnorm_logpdf(z, mu, step, lb[t], ub[t]);
        } else {
          z = mu + step * normal_icdf_from_bits(bits);
        }
        const float quad_cur = s2 - 2.0f * mu * s1 + s0 * mu * mu;
        const float quad_prop = s2 - 2.0f * z * s1 + s0 * z * z;
        const float dm = mu - mu0[t], dz = z - mu0[t];
        c_prop[t] = z;
        c_lik[t] = 0.5f * lam * (quad_cur - quad_prop);
        c_pri[t] = 0.5f * p0[t] * (dm * dm - dz * dz);
      }
    }
    if (!prm.conjugate) {
      __syncthreads();
      if (t == 0) {
        float delta = 0.0f;
        for (int k = 0; k < K; ++k) {
          if (prm.has_domain) {
            delta = delta + c_rev[k];
            delta = delta - c_fwd[k];
          }
          delta = delta + c_lik[k];
          delta = delta + c_pri[k];
        }
        const float u = uniform_from_bits(site_block(seed, chain, (uint32_t)it, 2u, 0u).x[0]);
        const bool accept = logf(u) < delta;
        acc = acc + (accept ? 1.0f : 0.0f);
        s_accept = accept ? 1 : 0;
      }
      __syncthreads();
      if (t < K) mu_new = s_accept ? c_prop[t] : c_mu[t];
    }

    // ---- precisions and the log-posterior terms of component t
    if (t < K) {
      const float quad = s2 - 2.0f * mu_new * s1 + s0 * mu_new * mu_new;
      const uint32_t site0 = prm.conjugate ? 2u : 3u;
      const float lam_new =
          gamma_mt_elem(a0[t] + 0.5f * s0, b0[t] + 0.5f * quad, seed, chain, (uint32_t)it, site0, (uint32_t)t);
      const float log_lam = logf(lam_new);
      const float dm = mu_new - mu0[t];
      c_lp[0][t] = 0.5f * s0 * (log_lam - kLog2Pi);
      c_lp[1][t] = 0.5f * lam_new * quad;
      c_lp[2][t] = s3;
      c_lp[3][t] = 0.5f * (logf(p0[t]) - kLog2Pi);
      c_lp[4][t] = 0.5f * p0[t] * (dm * dm);
      c_lp[5][t] = lgam[t];
      c_lp[6][t] = (a0[t] - 1.0f) * log_lam;
      c_lp[7][t] = b0[t] * lam_new;
      c_mu[t] = mu_new;
      c_lam[t] = lam_new;
      c_cl[t] = log_lam - kLog2Pi;
      c_hlam[t] = 0.5f * lam_new;
      c_mu2[t] = 2.0f * mu_new;
      if (idx >= 0) {
        const size_t o = ((size_t)chain * prm.n_keep + idx) * K + t;
        out_means[o] = mu_new;
        out_lams[o] = lam_new;
      }
    }
    __syncthreads();
    if (t == 0 && idx >= 0) {
      float lp = 0.0f;
      for (int k = 0; k < K; ++k) {
        lp = lp + c_lp[0][k];
        lp = lp - c_lp[1][k];
        lp = lp + c_lp[2][k];
        lp = lp + c_lp[3][k];
        lp = lp - c_lp[4][k];
        lp = lp + c_lp[5][k];
        lp = lp + c_lp[6][k];
        lp = lp - c_lp[7][k];
      }
      out_lp[(size_t)chain * prm.n_keep + idx] = lp;
    }
  }
  if (t == 0) out_acc[chain] = acc;
}

template <int KB>
static int launch(const MixParams& prm, const float* scal, const float* data, float* out_means, float* out_lams,
                  float* out_lp, float* out_acc, int* out_z, cudaStream_t stream) {
  const int smem = 4 * prm.k * prm.threads * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mixture_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mixture_kernel<KB><<<prm.n_chains, prm.threads, smem, stream>>>(prm, scal, data, out_means, out_lams, out_lp,
                                                                   out_acc, out_z);
  return (int)cudaGetLastError();
}

extern "C" int mixture_launch(const MixParams* prm, const float* scal, const float* data, float* out_means,
                              float* out_lams, float* out_lp, float* out_acc, int* out_z, cudaStream_t stream) {
  const int t = prm->threads;
  if (prm->k < 1 || prm->k > kMaxK || prm->n < 1 || prm->n4 < prm->n || prm->n4 % 4 != 0 ||
      (t != 32 && t != 64 && t != 128 && t != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  if (prm->k <= 2) return launch<2>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  if (prm->k <= 4) return launch<4>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  if (prm->k <= 8) return launch<8>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  if (prm->k <= 16) return launch<16>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
  return launch<32>(*prm, scal, data, out_means, out_lams, out_lp, out_acc, out_z, stream);
}
