// rj: the whole reversible-jump knot-basis regression run, every sweep for every
// chain in one launch, n_max <= 32 padded basis columns.
//
// Replaces the TPU kernel openmcmc_tpu/fused/rj.py:_make_kernel (pallas_call at
// rj.py:682). Model: k ~ Poisson(rho), theta_j ~ U(lo, hi), omega_j ~ Gamma(a, b),
// beta ~ N(mu_b, tau_b^-1 I_k), basis B[:, j] = normpdf(X; theta_j, omega_j)
// (j < k), and y ~ Null or y ~ N(B beta, (tau I)^-1) with a conjugate Gamma tau.
// One sweep per chain:
//   1. masked manifold MALA on beta: Null, the constant diagonal metric; with a
//      likelihood, the Fisher metric tau B'B + tau_b I through a column Cholesky;
//   2/3. truncated random walks on theta (uniform target) and omega (Gamma
//      target): Null, every column at once; with a likelihood, column by column
//      with the running residual;
//   4. birth or death with prediction-matched coefficient transitions: one Gram
//      G0 of the masked basis, S_birth, C_birth, S_death and C_death as rank-one
//      diagonal modifications of it, four Choleskys with pivots clamped at 1e-30,
//      two triangular solves;
//   5. with a likelihood, the Gamma draw of tau and the end-of-sweep log posterior;
// every expression in the JAX kernel's operation order (compiled with
// --fmad=false, like the plain version in openmcmc_tpu_torch/fused/rj.py).
//
// Summation order, the same in the plain version: a sum over the n_data rows has
// lane l add rows l, l + 32, ... ascending, then the 32 partials meet in a halving
// tree (warp_tree); a sum over the padded index j, a matrix-vector product and the
// Cholesky's updates add one term at a time in ascending order; the triangular
// solves follow the JAX kernel's order (the back substitution on lane 0).
//
// Bits: Philox4x32-10 (philox.cuh), key (seed, 0), counter (chain, sweep, site,
// j / 4), word j % 4; the site of every draw in the JAX kernel's order, numbered
// on the host (fused/rj.py: site_map) and passed in RjParams.
//
// Design: one warp per chain, two chains per block. The lane is the padded index
// j for the vectors and the row index of the p x p matrices, which live in shared
// memory column-major (column j, row i at [32 j + i]): G0 and two work matrices.
// The basis columns (p rows of npad = n_data rounded up to 32 floats), the
// residual and two work rows live in a per-chain global scratch, which stays in
// L2 at the cells' sizes (20 x 64 floats per chain at n_data = 50); for the data
// sums lane l reads rows l, l + 32, ..., coalesced. Scalars of the chain (k, tau,
// the counters, the accept decisions) are computed redundantly by every lane.
//
// What bounds it on an H100: latency. Each sweep is a long dependent chain of
// warp reductions, shuffles and small serial solves per chain; a whole run is a
// few thousand sweeps of it.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

struct RjParams {
  uint32_t seed;
  int32_t n_chains, p, n_data, n_sweeps, n_burn, n_thin, n_keep, lik, stream, n_rows, n_init;
  int32_t site_move, site_th_new, site_draw, site_delete, site_accept;
  GammaSpec g_om, g_tau;
  float rho, log_rho, mu_b, tau_b, half_tau_b, neg_half_tau_b, log_tau_term, a_om_m1, b_om, lgam_om;
  float log_range_th, th_lo, th_hi, th_range, om_lo, om_hi, m_lo, m_hi, m_scale, s_theta, s_omega, s_mmala;
  float drift, drift_c, sigma, c_prop, half_s2, c_q, half_n, a_tau_m1, b_tau, lgam_tau;
  float log_ints[32];
};

static constexpr unsigned kFull = 0xffffffffu;
static constexpr float kLog2Pi = 1.83787706640934534f;
static constexpr float kRidge = 1e-6f;
static constexpr int kWarps = 2;  // chains per block

struct WarpSmem {
  float G[32 * 32];   // the masked basis's Gram, column-major
  float W1[32 * 32];  // work matrices: H and L_h, S_birth and L_b, C_death and L_cd
  float W2[32 * 32];  // C_birth, S_death
  float coef[32];     // a coefficient vector staged for the data loops
  float coef2[32];
  float w[32];        // forward-solve intermediate
  float x[32];        // a solve's result
};

// The data-row sum's halving tree over the 32 lane partials, broadcast.
__device__ __forceinline__ float warp_tree(float s) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(kFull, s, h);
  return __shfl_sync(kFull, s, 0);
}

// Sum over the padded index: lane j's v, one term at a time for j = 0..p-1.
__device__ __forceinline__ float jsum(float v, int p) {
  float s = __shfl_sync(kFull, v, 0);
  for (int j = 1; j < p; ++j) s = s + __shfl_sync(kFull, v, j);
  return s;
}

// The JAX kernel's basis_col entry: exp(-z^2/2) / (om sqrt(2 pi)) * active, om <= 0 read as 1.
__device__ __forceinline__ float basis_val(float x, float th, float om, float active) {
  const float om_safe = om > 0.0f ? om : 1.0f;
  const float z = (x - th) / om_safe;
  return expf(-0.5f * z * z) / (om_safe * 2.50662827463100024f) * active;
}

// Left-looking Cholesky of the shared column-major M in place (chol_cols); returns log det.
__device__ float chol_inplace(float* M, int p, int lane) {
  float logdet = 0.0f;
  for (int j = 0; j < p; ++j) {
    float col = M[32 * j + lane];
    for (int m = 0; m < j; ++m) col = col - M[32 * m + lane] * M[32 * m + j];
    const float d = sqrtf(fmaxf(__shfl_sync(kFull, col, j), 1e-30f));
    logdet = logdet + 2.0f * logf(d);
    __syncwarp();
    M[32 * j + lane] = lane >= j ? col / d : 0.0f;
    __syncwarp();
  }
  return logdet;
}

// L' x = z (chol_backsolve) on lane 0, z in w, the result in x; both shared.
__device__ void back_subst(const float* L, const float* z, float* x, int p, int lane) {
  if (lane == 0) {
    for (int i = p - 1; i >= 0; --i) {
      float acc = z[i];
      for (int m = i + 1; m < p; ++m) acc = acc - L[32 * i + m] * x[m];
      x[i] = acc / L[32 * i + i];
    }
  }
  __syncwarp();
}

// A x = r from the column Cholesky L of A (chol_solve_1rhs); lane l holds r_l,
// the result lands in sm.x.
__device__ void chol_solve(const float* L, float r, WarpSmem& sm, int p, int lane) {
  float res = r;
  for (int i = 0; i < p; ++i) {
    const float wi = __shfl_sync(kFull, res, i) / L[32 * i + i];
    if (lane == 0) sm.w[i] = wi;
    res = res - L[32 * i + lane] * wi;
  }
  __syncwarp();
  back_subst(L, sm.w, sm.x, p, lane);
}

// The joint log density without the likelihood (model_log_p), lane l's padded entries.
__device__ float model_log_p(const RjParams& c, float kf, float beta, float theta, float omega, float m) {
  float log_fact = 0.0f;
  for (int i = 2; i <= c.p; ++i) log_fact = log_fact + ((float)i <= kf ? c.log_ints[i - 1] : 0.0f);
  const float lp = kf * c.log_rho - c.rho - log_fact - kf * c.log_range_th;
  const float r = beta - c.mu_b;
  const float om_safe = m > 0.0f ? omega : 1.0f;
  const float terms = c.log_tau_term - c.half_tau_b * r * r + c.a_om_m1 * logf(om_safe) - c.b_om * om_safe + c.lgam_om;
  return lp + jsum(m * terms, c.p);
}

__device__ __forceinline__ float uniform_site(const RjParams& c, uint32_t chain, uint32_t it, int site) {
  return uniform_from_bits(site_block(c.seed, chain, it, (uint32_t)site, 0u).x[0]);
}

__device__ __forceinline__ uint32_t lane_bits(const RjParams& c, uint32_t chain, uint32_t it, int site, int lane) {
  return site_block(c.seed, chain, it, (uint32_t)site, (uint32_t)lane / 4u).x[lane % 4];
}

// The Gram of the p basis rows into the shared G, one data-row sum per pair.
__device__ void gram(const float* bas, int npad, int n, int p, float* G, int lane) {
  for (int i = 0; i < p; ++i) {
    for (int j = i; j < p; ++j) {
      float s = 0.0f;
      for (int r = lane; r < n; r += 32) s = s + bas[i * npad + r] * bas[j * npad + r];
      const float g = warp_tree(s);
      if (lane == 0) {
        G[32 * j + i] = g;
        G[32 * i + j] = g;
      }
    }
  }
  __syncwarp();
}

// The data-row sum of row a times row b (b may be a, or the same for every i).
__device__ __forceinline__ float row_dot(const float* a, const float* b, int n, int lane) {
  float s = 0.0f;
  for (int r = lane; r < n; r += 32) s = s + a[r] * b[r];
  return warp_tree(s);
}

// fit(row) = 0 + sum_j bas_j(row) coef_j for the rows of this lane, into out.
__device__ __forceinline__ void fit_rows(const float* bas, int npad, int n, int p, const float* coef, float* out,
                                         int lane) {
  for (int r = lane; r < n; r += 32) {
    float f = 0.0f;
    for (int j = 0; j < p; ++j) f = f + bas[j * npad + r] * coef[j];
    out[r] = f;
  }
}

__global__ void __launch_bounds__(32 * kWarps) rj_kernel(RjParams c, const float* __restrict__ data,
                                                         const float* __restrict__ init, float* __restrict__ scratch,
                                                         float* __restrict__ out) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chain_i = blockIdx.x * kWarps + warp;
  if (chain_i >= c.n_chains) return;  // a whole warp leaves; no block-wide barrier follows
  WarpSmem& sm = smem[warp];
  const uint32_t chain = (uint32_t)chain_i;
  const int p = c.p, n = c.n_data, npad = (n + 31) / 32 * 32;
  const bool lik = c.lik != 0;
  const float* X = data;
  const float* Y = data + n;
  float* bas = scratch + (size_t)chain_i * (p + 3) * npad;  // p basis rows
  float* res = bas + (size_t)p * npad;                     // the running residual
  float* row1 = res + npad;                                // new column, dB
  float* row2 = row1 + npad;                               // B beta for the birth's right-hand side

  const float* ini = init + (size_t)chain_i * c.n_init;
  const bool on = lane < p;
  float beta = on ? ini[lane] : 0.0f, theta = on ? ini[p + lane] : 0.0f, omega = on ? ini[2 * p + lane] : 0.0f;
  float kf = ini[3 * p];
  int base = 3 * p + 1;
  float tau = 0.0f;
  if (lik) tau = ini[base++];
  float acc_m = ini[base], acc_t = ini[base + 1], acc_o = ini[base + 2], acc_r = ini[base + 3];
  float prop_t = ini[base + 4], prop_o = ini[base + 5];

  for (int it_i = 0; it_i < c.n_sweeps; ++it_i) {
    const uint32_t it = (uint32_t)it_i;
    float m = (on && (float)lane < kf) ? 1.0f : 0.0f;

    if (lik) {
      // the basis and the residual y - B beta, rebuilt at the start of the sweep
      sm.coef[lane] = beta;
      __syncwarp();
      for (int j = 0; j < p; ++j) {
        const float th = __shfl_sync(kFull, theta, j), om = __shfl_sync(kFull, omega, j);
        const float mj = __shfl_sync(kFull, m, j);
        for (int r = lane; r < n; r += 32) bas[j * npad + r] = basis_val(__ldg(X + r), th, om, mj);
      }
      __syncwarp();
      for (int r = lane; r < n; r += 32) {
        float f = 0.0f;
        for (int j = 0; j < p; ++j) f = f + bas[j * npad + r] * sm.coef[j];
        res[r] = __ldg(Y + r) - f;
      }
      __syncwarp();
    }

    // ==== 1. manifold MALA on beta =========================================
    bool acc;
    if (lik) {
      gram(bas, npad, n, p, sm.G, lane);
      float g = 0.0f;
      for (int i = 0; i < p; ++i) {
        const float t = row_dot(bas + i * npad, res, n, lane);
        if (lane == i) g = (tau * t - c.tau_b * (beta - c.mu_b)) * m;
      }
      for (int j = 0; j < p; ++j) {
        const float mj = __shfl_sync(kFull, m, j);
        float h = tau * sm.G[32 * j + lane] * m * mj;
        if (lane == j) h = h + (c.tau_b * mj + (1.0f - mj));
        sm.W2[32 * j + lane] = h;  // H, kept for H d_r
        sm.W1[32 * j + lane] = h;  // factored into L_h
      }
      __syncwarp();
      chol_inplace(sm.W1, p, lane);
      chol_solve(sm.W1, g, sm, p, lane);
      const float hg = sm.x[lane];
      const float z = normal_icdf_from_bits(lane_bits(c, chain, it, 0, lane)) * m;
      __syncwarp();
      sm.w[lane] = z;
      __syncwarp();
      back_subst(sm.W1, sm.w, sm.x, p, lane);
      const float ltz = sm.x[lane];
      const float mu_f = beta + c.half_s2 * hg;
      const float beta_prop = m > 0.0f ? mu_f + c.s_mmala * ltz : beta;
      const float delta = beta_prop - beta;
      const float d_r = beta - (beta_prop + c.half_s2 * (hg - delta));
      float hdr = 0.0f;
      for (int j = 0; j < p; ++j) hdr = hdr + sm.W2[32 * j + lane] * __shfl_sync(kFull, d_r, j);
      const float q_r = jsum(d_r * hdr, p);
      const float zz = jsum(z * z, p);
      const float logq_diff = c.c_q * q_r + 0.5f * zz;
      __syncwarp();
      sm.coef[lane] = delta;
      __syncwarp();
      fit_rows(bas, npad, n, p, sm.coef, row1, lane);  // dB
      __syncwarp();
      const float s1 = row_dot(res, row1, n, lane), s2 = row_dot(row1, row1, n, lane);
      const float d_ll = tau * s1 - 0.5f * tau * s2;
      const float d_prior = jsum(
          m * (c.neg_half_tau_b * ((beta_prop - c.mu_b) * (beta_prop - c.mu_b) - (beta - c.mu_b) * (beta - c.mu_b))), p);
      acc = logf(uniform_site(c, chain, it, 1)) < (d_prior + d_ll + logq_diff);
      if (acc) {
        beta = beta_prop;
        for (int r = lane; r < n; r += 32) res[r] = res[r] - row1[r];
      }
      __syncwarp();
    } else {
      const float z = normal_icdf_from_bits(lane_bits(c, chain, it, 0, lane));
      const float mu_f = c.drift * beta + c.drift_c;
      const float beta_prop = m > 0.0f ? mu_f + c.sigma * z : beta;
      const float mu_r = c.drift * beta_prop + c.drift_c;
      const float a = (beta_prop - c.mu_b) * (beta_prop - c.mu_b) - (beta - c.mu_b) * (beta - c.mu_b);
      const float b = (beta - mu_r) * (beta - mu_r) - (beta_prop - mu_f) * (beta_prop - mu_f);
      const float dlp = jsum(m * (c.neg_half_tau_b * a - c.c_prop * b), p);
      acc = logf(uniform_site(c, chain, it, 1)) < dlp;
      if (acc) beta = beta_prop;
    }
    acc_m = acc_m + (acc ? 1.0f : 0.0f);

    // ==== 2/3. truncated random walks on theta and omega ===================
    if (lik) {
      for (int pass = 0; pass < 2; ++pass) {  // theta's columns, then omega's
        for (int j = 0; j < p; ++j) {
          const int s0 = 2 + 2 * p * pass + 2 * j;
          const float aj = __shfl_sync(kFull, m, j), bj = __shfl_sync(kFull, beta, j);
          const float th_j = __shfl_sync(kFull, theta, j), om_j = __shfl_sync(kFull, omega, j);
          const uint32_t bits = site_block(c.seed, chain, it, (uint32_t)s0, 0u).x[0];
          const float nv = pass == 0 ? truncnorm_from_bits(th_j, c.s_theta, c.th_lo, c.th_hi, bits)
                                     : truncnorm_from_bits(om_j, c.s_omega, c.om_lo, c.om_hi, bits);
          const float th_c = pass == 0 ? nv : th_j, om_c = pass == 0 ? om_j : nv;
          float* col = bas + j * npad;
          float s1 = 0.0f, s2 = 0.0f;
          for (int r = lane; r < n; r += 32) {
            const float dc = (basis_val(__ldg(X + r), th_c, om_c, aj) - col[r]) * bj;
            s1 = s1 + res[r] * dc;
            s2 = s2 + dc * dc;
          }
          const float d_ll = tau * warp_tree(s1) - 0.5f * tau * warp_tree(s2);
          float log_ratio;
          if (pass == 0) {
            const float corr = truncnorm_logpdf(th_j, nv, c.s_theta, c.th_lo, c.th_hi) -
                               truncnorm_logpdf(nv, th_j, c.s_theta, c.th_lo, c.th_hi);
            log_ratio = d_ll + corr;
          } else {
            const float om_safe_c = om_j > 0.0f ? om_j : 1.0f, om_safe_p = nv > 0.0f ? nv : 1.0f;
            const float dtarget = c.a_om_m1 * (logf(om_safe_p) - logf(om_safe_c)) - c.b_om * (nv - om_j);
            const float corr = truncnorm_logpdf(om_j, nv, c.s_omega, c.om_lo, c.om_hi) -
                               truncnorm_logpdf(nv, om_j, c.s_omega, c.om_lo, c.om_hi);
            log_ratio = dtarget + d_ll + corr;
          }
          bool acc_j = logf(uniform_site(c, chain, it, s0 + 1)) < log_ratio && aj > 0.0f;
          if (pass == 1) acc_j = acc_j && nv > 0.0f;
          if (acc_j) {
            __syncwarp();
            for (int r = lane; r < n; r += 32) {
              const float cn = basis_val(__ldg(X + r), th_c, om_c, aj);
              const float dc = (cn - col[r]) * bj;
              col[r] = cn;
              res[r] = res[r] - dc;
            }
            if (lane == j) {
              if (pass == 0) theta = nv;
              else omega = nv;
            }
          }
          __syncwarp();
          if (pass == 0) acc_t = acc_t + (acc_j ? 1.0f : 0.0f);
          else acc_o = acc_o + (acc_j ? 1.0f : 0.0f);
        }
        if (pass == 0) prop_t = prop_t + kf;
        else prop_o = prop_o + kf;
      }
    } else {
      {
        const float th_prop = truncnorm_from_bits(theta, c.s_theta, c.th_lo, c.th_hi, lane_bits(c, chain, it, 2, lane));
        const float lf = truncnorm_logpdf(th_prop, theta, c.s_theta, c.th_lo, c.th_hi);
        const float lr = truncnorm_logpdf(theta, th_prop, c.s_theta, c.th_lo, c.th_hi);
        const bool a = logf(uniform_from_bits(lane_bits(c, chain, it, 3, lane))) < (lr - lf) && m > 0.0f;
        if (a) theta = th_prop;
        acc_t = acc_t + (float)__popc(__ballot_sync(kFull, a));
        prop_t = prop_t + kf;
      }
      {
        const float om_prop = truncnorm_from_bits(omega, c.s_omega, c.om_lo, c.om_hi, lane_bits(c, chain, it, 4, lane));
        const float lf = truncnorm_logpdf(om_prop, omega, c.s_omega, c.om_lo, c.om_hi);
        const float lr = truncnorm_logpdf(omega, om_prop, c.s_omega, c.om_lo, c.om_hi);
        const float om_safe_c = omega > 0.0f ? omega : 1.0f, om_safe_p = om_prop > 0.0f ? om_prop : 1.0f;
        const float dtarget = c.a_om_m1 * (logf(om_safe_p) - logf(om_safe_c)) - c.b_om * (om_prop - omega);
        bool a = logf(uniform_from_bits(lane_bits(c, chain, it, 5, lane))) < (dtarget + lr - lf) && m > 0.0f;
        a = a && om_prop > 0.0f;
        if (a) omega = om_prop;
        acc_o = acc_o + (float)__popc(__ballot_sync(kFull, a));
        prop_o = prop_o + kf;
      }
      for (int j = 0; j < p; ++j) {
        const float th = __shfl_sync(kFull, theta, j), om = __shfl_sync(kFull, omega, j);
        const float mj = __shfl_sync(kFull, m, j);
        for (int r = lane; r < n; r += 32) bas[j * npad + r] = basis_val(__ldg(X + r), th, om, mj);
      }
      __syncwarp();
    }

    // ==== 4. reversible jump ===============================================
    gram(bas, npad, n, p, sm.G, lane);
    const float u_move = uniform_site(c, chain, it, c.site_move);
    const bool birth = kf >= (float)p ? false : (kf <= 1.0f ? true : u_move <= 0.5f);
    const bool is_k = (float)lane == kf, lt_k = (float)lane < kf, lt_k1 = (float)lane < kf + 1.0f;

    // ---- birth
    const float th_new = c.th_lo + c.th_range * uniform_site(c, chain, it, c.site_th_new);
    const float om_new = gamma_draw(c.g_om, c.b_om, c.seed, chain, it);
    for (int r = lane; r < n; r += 32) row1[r] = basis_val(__ldg(X + r), th_new, om_new, 1.0f);
    const float log_new = -c.log_range_th + c.a_om_m1 * logf(om_new) - c.b_om * om_new + c.lgam_om;
    __syncwarp();
    float ndot = 0.0f;
    for (int i = 0; i < p; ++i) {
      const float t = row_dot(row1, bas + i * npad, n, lane);
      if (lane == i) ndot = t;
    }
    const float nn = row_dot(row1, row1, n, lane);
    const float nd_kk = is_k ? nn : ndot;
    for (int j = 0; j < p; ++j) {  // S_birth into W1, C_birth into W2
      const bool j_k = (float)j == kf, j_lt1 = (float)j < kf + 1.0f, j_lt = (float)j < kf;
      const float nd_j = __shfl_sync(kFull, ndot, j);
      float v = is_k ? nd_j : sm.G[32 * j + lane];
      if (j_k) v = nd_kk;
      if (!(lt_k1 && j_lt1)) v = 0.0f;
      float cb = v;
      if (lane == j) {
        v = v + (j_lt1 ? kRidge : 1.0f);
        cb = v - (j_lt ? kRidge : 0.0f);
      }
      sm.W1[32 * j + lane] = v;
      sm.W2[32 * j + lane] = cb;
    }
    __syncwarp();
    const float logdet_Sb = chol_inplace(sm.W1, p, lane);
    sm.coef[lane] = beta;
    __syncwarp();
    fit_rows(bas, npad, n, p, sm.coef, row2, lane);  // B beta
    __syncwarp();
    float base_dot = 0.0f;
    for (int i = 0; i < p; ++i) {
      const float t = row_dot(bas + i * npad, row2, n, lane);
      if (lane == i) base_dot = t;
    }
    const float new_dot_r = row_dot(row1, row2, n, lane);
    const float rhs = lt_k1 ? (is_k ? new_dot_r : base_dot) : 0.0f;
    chol_solve(sm.W1, rhs, sm, p, lane);
    const float mu_star = sm.x[lane];
    const int k_i = (int)kf;
    const float mu_k = __shfl_sync(kFull, mu_star, k_i & 31);
    const float mu_new = k_i < p ? mu_k : 0.0f;
    const float draw = truncnorm_from_bits(mu_new, c.m_scale, c.m_lo, c.m_hi,
                                           site_block(c.seed, chain, it, (uint32_t)c.site_draw, 0u).x[0]);
    const float log_draw = truncnorm_logpdf(draw, mu_new, c.m_scale, c.m_lo, c.m_hi);
    const float beta_birth = lt_k ? mu_star : (is_k ? draw : 0.0f);
    const float logdet_Cb = chol_inplace(sm.W2, p, lane);
    const float ld_F_birth = logdet_Cb - logdet_Sb;
    const float birth_fwd = logf(kf <= 1.0f ? 1.0f : 0.5f) + log_new + log_draw;
    const float birth_rev = logf(kf >= (float)(p - 1) ? 1.0f : 0.5f) + ld_F_birth;
    const float th_birth = is_k ? th_new : theta, om_birth = is_k ? om_new : omega;

    // ---- death
    const float u_del = uniform_site(c, chain, it, c.site_delete);
    const float jf = fminf(fmaxf(floorf(u_del * kf), 0.0f), fmaxf(kf - 1.0f, 0.0f));
    const int j_i = (int)jf;
    const bool is_j = (float)lane == jf;
    const float om_del = __shfl_sync(kFull, omega, j_i & 31);
    const float om_del_safe = om_del > 0.0f ? om_del : 1.0f;
    const float log_del = -c.log_range_th + c.a_om_m1 * logf(om_del_safe) - c.b_om * om_del_safe + c.lgam_om;
    __syncwarp();
    float s_beta = 0.0f;
    for (int j = 0; j < p; ++j) {  // S_death into W2, C_death into W1, S_death beta
      const bool j_lt = (float)j < kf;
      float v = (lt_k && j_lt) ? sm.G[32 * j + lane] : 0.0f;
      float cd = v;
      if (lane == j) {
        v = v + (j_lt ? kRidge : 1.0f);
        cd = v + kRidge * ((is_j ? 1.0f : 0.0f) - (lt_k ? 1.0f : 0.0f));
      }
      s_beta = s_beta + v * __shfl_sync(kFull, beta, j);
      sm.W2[32 * j + lane] = v;
      sm.W1[32 * j + lane] = cd;
    }
    __syncwarp();
    const float logdet_Sd = chol_inplace(sm.W2, p, lane);
    const float logdet_Cd = chol_inplace(sm.W1, p, lane);
    chol_solve(sm.W1, s_beta, sm, p, lane);
    const float mu_aug = sm.x[lane];
    const float ld_F_death = logdet_Cd - logdet_Sd;
    const float param_del = __shfl_sync(kFull, mu_aug, j_i & 31);
    const float log_rev_draw = truncnorm_logpdf(param_del, 0.0f, c.m_scale, c.m_lo, c.m_hi);
    const float mu_next = __shfl_down_sync(kFull, mu_aug, 1), th_next = __shfl_down_sync(kFull, theta, 1);
    const float om_next = __shfl_down_sync(kFull, omega, 1);
    const bool keep = (float)lane < jf, live = (float)lane < kf - 1.0f, has_next = lane + 1 < p;
    const float beta_death = live ? (keep ? mu_aug : (has_next ? mu_next : 0.0f)) : 0.0f;
    const float th_death = live ? (keep ? theta : (has_next ? th_next : 0.0f)) : 0.0f;
    const float om_death = live ? (keep ? omega : (has_next ? om_next : 0.0f)) : 0.0f;
    const float death_fwd = logf(kf >= (float)p ? 1.0f : 0.5f) + ld_F_death;
    const float death_rev = logf(kf <= 2.0f ? 1.0f : 0.5f) + log_del + log_rev_draw;

    // ---- branch select and accept
    const float kf_prop = birth ? kf + 1.0f : kf - 1.0f;
    const float beta_p = birth ? beta_birth : beta_death;
    const float th_p = birth ? th_birth : th_death, om_p = birth ? om_birth : om_death;
    const float logp_fwd = birth ? birth_fwd : death_fwd, logp_rev = birth ? birth_rev : death_rev;
    const float m_prop = (on && (float)lane < kf_prop) ? 1.0f : 0.0f;
    const float lp_cur = model_log_p(c, kf, beta, theta, omega, m);
    const float lp_prop = model_log_p(c, kf_prop, beta_p, th_p, om_p, m_prop);
    float log_accept, quad_cur = 0.0f, quad_prop = 0.0f;
    if (lik) {
      quad_cur = row_dot(res, res, n, lane);
      __syncwarp();
      sm.coef[lane] = lt_k ? mu_star : 0.0f;
      sm.coef2[lane] = (lt_k && !is_j) ? mu_aug : 0.0f;
      __syncwarp();
      float sb = 0.0f, sd = 0.0f;
      for (int r = lane; r < n; r += 32) {
        float fb = 0.0f, fd = 0.0f;
        for (int i = 0; i < p; ++i) {
          const float bv = bas[i * npad + r];
          fb = fb + bv * sm.coef[i];
          fd = fd + bv * sm.coef2[i];
        }
        const float y = __ldg(Y + r);
        const float rb = y - fb - row1[r] * draw, rd = y - fd;
        sb = sb + rb * rb;
        sd = sd + rd * rd;
      }
      const float quad_birth = warp_tree(sb), quad_death = warp_tree(sd);
      quad_prop = birth ? quad_birth : quad_death;
      const float ll_prop = c.half_n * (logf(tau) - kLog2Pi) - 0.5f * tau * quad_prop;
      const float ll_cur = c.half_n * (logf(tau) - kLog2Pi) - 0.5f * tau * quad_cur;
      log_accept = lp_prop + ll_prop + logp_rev - lp_cur - ll_cur - logp_fwd;
    } else {
      log_accept = lp_prop + logp_rev - lp_cur - logp_fwd;
    }
    acc = logf(uniform_site(c, chain, it, c.site_accept)) < log_accept;
    if (acc) {
      kf = kf_prop;
      beta = beta_p;
      theta = th_p;
      omega = om_p;
    }
    acc_r = acc_r + (acc ? 1.0f : 0.0f);
    float log_post;
    if (lik) {
      // ==== 5. conjugate Gamma draw of tau, end-of-sweep log posterior ======
      const float quad_sel = acc ? quad_prop : quad_cur;
      const float lp_sel = acc ? lp_prop : lp_cur;
      tau = gamma_draw(c.g_tau, c.b_tau + 0.5f * quad_sel, c.seed, chain, it);
      const float log_tau = logf(tau);
      log_post = lp_sel + c.half_n * (log_tau - kLog2Pi) - 0.5f * tau * quad_sel + c.lgam_tau + c.a_tau_m1 * log_tau -
                 c.b_tau * tau;
    } else {
      log_post = acc ? lp_prop : lp_cur;
    }
    __syncwarp();

    // ---- store
    const int idx = store_index(it_i, c.n_burn, c.n_thin);
    if (idx >= 0) {
      float* o = out + ((size_t)chain_i * c.n_keep + idx) * c.n_rows;
      if (lane == 0) {
        o[0] = kf;
        o[1] = log_post;
        o[2] = acc_m;
        o[3] = acc_t;
        o[4] = acc_o;
        o[5] = acc_r;
        o[6] = prop_t;
        o[7] = prop_o;
        if (lik) o[8] = tau;
      }
      if (c.stream && on) {
        const int b0 = 8 + (lik ? 1 : 0);
        o[b0 + lane] = beta;
        o[b0 + p + lane] = theta;
        o[b0 + 2 * p + lane] = omega;
      }
    }
  }
}

extern "C" int rj_launch(const RjParams* prm, const float* data, const float* init, float* scratch, float* out,
                         cudaStream_t stream) {
  if (prm->p < 1 || prm->p > 32 || prm->n_data < 1 || prm->n_chains < 1 || prm->n_keep < 1 || prm->n_thin < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (prm->n_chains + kWarps - 1) / kWarps;
  rj_kernel<<<blocks, 32 * kWarps, 0, stream>>>(*prm, data, init, scratch, out);
  return (int)cudaGetLastError();
}
