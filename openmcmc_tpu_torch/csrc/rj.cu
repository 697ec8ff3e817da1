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
// What bounds it on an H100: stalls of one warp per chain, not arithmetic. A sweep
// runs a long path of code once (its draws, densities and small factorizations),
// and a run is thousands of sweeps; at the cells' 2048 chains an SM holds 15.5
// warps, which cannot hide a path that misses the instruction cache or waits on
// dependent steps. Measured on the card (PERF.md, section 6): the time followed the
// code the sweep runs, not its floating-point work.
//
// Design: one warp per chain, two chains per block; the lane is the padded index
// j for the vectors and the row index of the p x p matrices.
// - Every loop runs at the chain's active size: k columns (k + 1 for the birth's
//   matrices), not n_max. The padded slots of the plain version hold exact zeros
//   and identity entries (a masked basis column is 0, a padded coefficient is 0,
//   the matrices are [A 0; 0 I]), which add +0, multiply by 0 or factor to
//   [L 0; 0 I] with log 1 = 0, so the values are the plain version's; the Philox
//   stream is counter-based, so a skipped draw shifts no other.
// - Sums over the data rows run kGroup at a time (the Gram's pairs with the
//   gradient's dots; the birth's dots): independent loads and kGroup warp_trees
//   interleaved, each the bits of one warp_tree, in a loop of small code.
// - The sweep's single-value draws (the move, the new knot, the Gamma rounds, the
//   matched draw, the deletion, the accepts) come from one lane-parallel Philox
//   evaluation, each lane a site, and reach the others by shuffles.
// - The likelihood walks' proposals, accept uniforms and density terms are drawn
//   lane-parallel at the start of each pass (each reads only its own column);
//   the column loop keeps only the residual's sums and the accept.
// - The birth's and the death's two Choleskys run interleaved, as do the mMALA's
//   two back substitutions, each one out-of-line copy; inner loops are unrolled,
//   their order unchanged.
// - The basis rows, the residual and two work rows live in a per-chain global
//   scratch, which stays in L2 (n_data * (n_max + 3) floats a chain).
// The matrices live column-major in shared memory at stride p (column j, row i
// at [p j + i]); lanes >= the active size compute values nobody reads, and write
// no matrix entry.
#include <cuda_runtime.h>

#include "layout.cuh"
#include "prng.cuh"

// The sampling functions of prng.cuh, each one out-of-line copy for the many
// call sites of a sweep (the kernel's code size, not its arithmetic, is what
// these save: a sweep runs its code path once, and a long path misses the SM's
// instruction cache).
// Word w of the Philox block (site, j4), by selects (an indexed block would go
// to local memory).
__device__ __noinline__ uint32_t philox_word(uint32_t seed, uint32_t chain, uint32_t sweep, uint32_t site, uint32_t j4,
                                             uint32_t w) {
  const Philox4 b = site_block(seed, chain, sweep, site, j4);
  return w == 0u ? b.x[0] : w == 1u ? b.x[1] : w == 2u ? b.x[2] : b.x[3];
}
__device__ __noinline__ float truncnorm(float mu, float scale, float lo, float hi, uint32_t bits) {
  return truncnorm_from_bits(mu, scale, lo, hi, bits);
}
__device__ __noinline__ float tn_logpdf(float x, float mu, float scale, float lo, float hi) {
  return truncnorm_logpdf(x, mu, scale, lo, hi);
}
__device__ __noinline__ float normal(uint32_t bits) { return normal_icdf_from_bits(bits); }
// A Gamma draw (gamma_draw) on the sweep's single-value words: lane l holds
// word 0 of site base + l (sweep_words), and the spec's element is 0.
__device__ __noinline__ float gamma_words(const GammaSpec& g, float rate, uint32_t words, int base) {
  return gamma_from_words(g, rate, [&](int site) { return __shfl_sync(0xffffffffu, words, site - base); });
}

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
static constexpr int kWarps = 2;                // chains per block
static constexpr int kBlocksPerSm = 8;          // the launch bound: at most 128 registers a thread
static constexpr int kVecFloats = 6 * 32 + 68;  // coef, coef2, w, x, w2, x2 and dv (2 * 32 + 2 sums)
static constexpr int kGroup = 8;                // data-row sums reduced together

// A warp's shared floats: G, W1 and W2 (p x p each) and the vectors.
__host__ __device__ inline int warp_floats(int p) { return (3 * p * p + kVecFloats + 3) / 4 * 4; }

// The data-row sum's halving tree over the 32 lane partials, broadcast.
__device__ __forceinline__ float warp_tree(float s) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) s = s + __shfl_down_sync(kFull, s, h);
  return __shfl_sync(kFull, s, 0);
}

// Sum over the padded index: lane j's v, one term at a time for j = 0..cnt-1.
__device__ __forceinline__ float jsum(float v, int cnt) {
  float s = __shfl_sync(kFull, v, 0);
#pragma unroll 4
  for (int j = 1; j < cnt; ++j) s = s + __shfl_sync(kFull, v, j);
  return s;
}

// The JAX kernel's basis_col entry: exp(-z^2/2) / (om sqrt(2 pi)) * active, om <= 0 read as 1.
__device__ __forceinline__ float basis_val(float x, float th, float om, float active) {
  const float om_safe = om > 0.0f ? om : 1.0f;
  const float z = (x - th) / om_safe;
  return expf(-0.5f * z * z) / (om_safe * 2.50662827463100024f) * active;
}

// Left-looking Cholesky (chol_cols) of the leading m x m block of the shared
// column-major M (stride p) in place; returns log det. Column j subtracts
// L[:, k] L[j, k] for k = 0..j-1 in order; the pivot is sqrt(max(., 1e-30)).
__device__ __noinline__ float chol(float* M, int p, int m, int lane) {
  float logdet = 0.0f;
  for (int j = 0; j < m; ++j) {
    float col = M[p * j + lane];
#pragma unroll 4
    for (int k = 0; k < j; ++k) col = col - M[p * k + lane] * M[p * k + j];
    const float d = sqrtf(fmaxf(__shfl_sync(kFull, col, j), 1e-30f));
    logdet = logdet + 2.0f * logf(d);
    if (lane < m) M[p * j + lane] = lane >= j ? col / d : 0.0f;
    __syncwarp();
  }
  return logdet;
}

// chol of two matrices of the same size, interleaved; their log dets in la, lb.
__device__ __noinline__ void chol2(float* A, float* B, int p, int m, int lane, float& la, float& lb) {
  la = 0.0f;
  lb = 0.0f;
  for (int j = 0; j < m; ++j) {
    float ca = A[p * j + lane], cb = B[p * j + lane];
#pragma unroll 4
    for (int k = 0; k < j; ++k) {
      ca = ca - A[p * k + lane] * A[p * k + j];
      cb = cb - B[p * k + lane] * B[p * k + j];
    }
    const float da = sqrtf(fmaxf(__shfl_sync(kFull, ca, j), 1e-30f));
    const float db = sqrtf(fmaxf(__shfl_sync(kFull, cb, j), 1e-30f));
    la = la + 2.0f * logf(da);
    lb = lb + 2.0f * logf(db);
    if (lane < m) {
      A[p * j + lane] = lane >= j ? ca / da : 0.0f;
      B[p * j + lane] = lane >= j ? cb / db : 0.0f;
    }
    __syncwarp();
  }
}

// The forward pass of chol_solve_1rhs: L w = r for the m x m factor L, lane l
// holding r_l; the residual is updated column by column; w lands in shared w.
__device__ __noinline__ void forward(const float* L, int p, int m, float r, float* w, int lane) {
  float res = r;
  for (int i = 0; i < m; ++i) {
    const float wi = __shfl_sync(kFull, res, i) / L[p * i + i];
    if (lane == 0) w[i] = wi;
    res = res - L[p * i + lane] * wi;
  }
  __syncwarp();
}

// L' x = z (chol_backsolve) on lane 0, z and x shared: x_i = (z_i - sum_{k > i}
// L[k, i] x_k) / L[i, i], the sum in ascending k; x_{i+1} comes from a register.
__device__ __noinline__ void back(const float* L, int p, int m, const float* z, float* x, int lane) {
  if (lane == 0) {
    float xn = 0.0f;
    for (int i = m - 1; i >= 0; --i) {
      float acc = z[i];
      if (i + 1 < m) acc = acc - L[p * i + i + 1] * xn;
#pragma unroll 4
      for (int k = i + 2; k < m; ++k) acc = acc - L[p * i + k] * x[k];
      xn = acc / L[p * i + i];
      x[i] = xn;
    }
  }
  __syncwarp();
}

// back for two right-hand sides of one factor, interleaved.
__device__ __noinline__ void back2(const float* L, int p, int m, const float* z1, float* x1, const float* z2, float* x2, int lane) {
  if (lane == 0) {
    float xa = 0.0f, xb = 0.0f;
    for (int i = m - 1; i >= 0; --i) {
      float a = z1[i], b = z2[i];
      if (i + 1 < m) {
        const float l = L[p * i + i + 1];
        a = a - l * xa;
        b = b - l * xb;
      }
#pragma unroll 4
      for (int k = i + 2; k < m; ++k) {
        const float l = L[p * i + k];
        a = a - l * x1[k];
        b = b - l * x2[k];
      }
      const float d = L[p * i + i];
      xa = a / d;
      xb = b / d;
      x1[i] = xa;
      x2[i] = xb;
    }
  }
  __syncwarp();
}

// The joint log density without the likelihood (model_log_p), lane l's padded
// entries, at the active count kf (the masked terms add +0).
__device__ __noinline__ float model_log_p(const RjParams& c, float kf, float beta, float theta, float omega, float m) {
  const int ka = (int)kf;
  float log_fact = 0.0f;
  for (int i = 2; i <= ka; ++i) log_fact = log_fact + c.log_ints[i - 1];
  const float lp = kf * c.log_rho - c.rho - log_fact - kf * c.log_range_th;
  const float r = beta - c.mu_b;
  const float om_safe = m > 0.0f ? omega : 1.0f;
  const float terms = c.log_tau_term - c.half_tau_b * r * r + c.a_om_m1 * logf(om_safe) - c.b_om * om_safe + c.lgam_om;
  return lp + jsum(m * terms, ka);
}

// Lane j's word of a p-wide site (row j of the padded index).
__device__ __forceinline__ uint32_t lane_bits(const RjParams& c, uint32_t chain, uint32_t it, int site, int lane) {
  return philox_word(c.seed, chain, it, (uint32_t)site, (uint32_t)lane / 4u, (uint32_t)lane % 4u);
}

// The sweep's single-value sites in one lane-parallel draw: lane l < 31 holds
// word 0 of site site_move + l (the move, the new knot, the new width's Gamma
// rounds, the matched draw, the deletion, the accept, tau's Gamma rounds: at
// most 2 + 13 + 3 + 13 = 31 sites, a Gamma draw taking at most 2 * 6 + 1),
// lane 31 that of site 1 (the mMALA accept).
__device__ __forceinline__ uint32_t sweep_words(const RjParams& c, uint32_t chain, uint32_t it, int lane) {
  return philox_word(c.seed, chain, it, lane == 31 ? 1u : (uint32_t)(c.site_move + lane), 0u, 0u);
}

// Word 0 of single-value site `site` (1 or >= site_move) from sweep_words.
__device__ __forceinline__ uint32_t single(const RjParams& c, uint32_t words, int site) {
  return __shfl_sync(kFull, words, site == 1 ? 31 : site - c.site_move);
}

// kGroup data-row sums at once, each warp_tree's bits: entry q multiplies rows
// a[q] and b[q] of rows (npad floats apart); lane l adds its rows l, l + 32, ...
// ascending, then the kGroup trees run interleaved. Every lane gets every sum.
__device__ __forceinline__ void group_sums(const float* rows, int npad, int n, const int (&a)[kGroup],
                                           const int (&b)[kGroup], float (&s)[kGroup], int lane) {
#pragma unroll
  for (int q = 0; q < kGroup; ++q) s[q] = 0.0f;
  for (int r = lane; r < n; r += 32) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) s[q] = s[q] + rows[a[q] * npad + r] * rows[b[q] * npad + r];
  }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) s[q] = s[q] + __shfl_down_sync(kFull, s[q], h);
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q) s[q] = __shfl_sync(kFull, s[q], 0);
}

// The Gram of the k active basis rows into G (stride p, both triangles) and,
// with `grad`, the k dots of the basis rows with the residual (row p of rows)
// into dv. Entry t < k (k + 1) / 2 is the triangle's pair (i, j), row i times
// row j (t = j (j + 1) / 2 + i); the k entries after it are row i times the
// residual. Past the last entry a group repeats it.
__device__ __noinline__ void gram(const float* rows, int npad, int n, int p, int k, bool grad, float* G, float* dv,
                                  int lane) {
  const int tri = k * (k + 1) / 2, count = tri + (grad ? k : 0);
  int i = 0, j = 0;  // the pair of entry t0
  for (int t0 = 0; t0 < count; t0 += kGroup) {
    int a[kGroup], b[kGroup];
    int ii = i, jj = j;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      a[q] = ii;
      b[q] = jj < k ? jj : p;
      if (t0 + q + 1 < count) {
        const bool wrap = ii + 1 > jj;
        ii = wrap ? 0 : ii + 1;
        jj = wrap ? jj + 1 : jj;
      }
    }
    i = ii;
    j = jj;
    float s[kGroup];
    group_sums(rows, npad, n, a, b, s, lane);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (lane == q && t0 + q < count) {
        if (b[q] < p) {
          G[p * b[q] + a[q]] = s[q];
          G[p * a[q] + b[q]] = s[q];
        } else {
          dv[a[q]] = s[q];
        }
      }
    }
  }
  __syncwarp();
}

// The birth's data-row sums into dv: dv[i] = row1 . bas_i (i < k), dv[k] =
// row1 . row1, dv[k + 1 + i] = bas_i . row2 (i < k), dv[2 k + 1] = row1 . row2;
// rows p + 1 and p + 2 of rows are row1 and row2.
__device__ __noinline__ void birth_dots(const float* rows, int npad, int n, int p, int k, float* dv, int lane) {
  const int count = 2 * k + 2;
  for (int t0 = 0; t0 < count; t0 += kGroup) {
    int a[kGroup], b[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int t = min(t0 + q, count - 1);
      const bool second = t > k;
      const int i = second ? t - k - 1 : t;
      const int row = i == k ? p + 1 : i;
      a[q] = second ? row : p + 1;
      b[q] = second ? p + 2 : row;
    }
    float s[kGroup];
    group_sums(rows, npad, n, a, b, s, lane);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (lane == q && t0 + q < count) dv[t0 + q] = s[q];
    }
  }
  __syncwarp();
}

// The data-row sum of row a times row b.
__device__ __forceinline__ float row_dot(const float* a, const float* b, int n, int lane) {
  float s = 0.0f;
  for (int r = lane; r < n; r += 32) s = s + a[r] * b[r];
  return warp_tree(s);
}

// fit(row) = 0 + sum_{j < k} bas_j(row) coef_j for the rows of this lane, into out.
__device__ __forceinline__ void fit_rows(const float* bas, int npad, int n, int k, const float* coef, float* out,
                                         int lane) {
  for (int r = lane; r < n; r += 32) {
    float f = 0.0f;
#pragma unroll 4
    for (int j = 0; j < k; ++j) f = f + bas[j * npad + r] * coef[j];
    out[r] = f;
  }
}

// The k active basis rows.
__device__ __noinline__ void basis_rows(const float* X, float theta, float omega, float m, int k, int n,
                                           float* bas, int npad, int lane) {
  for (int j = 0; j < k; ++j) {
    const float th = __shfl_sync(kFull, theta, j), om = __shfl_sync(kFull, omega, j);
    const float mj = __shfl_sync(kFull, m, j);
    for (int r = lane; r < n; r += 32) bas[j * npad + r] = basis_val(__ldg(X + r), th, om, mj);
  }
}

__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm) rj_kernel(RjParams c, const float* __restrict__ data,
                                                                        const float* __restrict__ init,
                                                                        float* __restrict__ scratch,
                                                                        float* __restrict__ out) {
  extern __shared__ float smem_all[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chain_i = blockIdx.x * kWarps + warp;
  if (chain_i >= c.n_chains) return;  // a whole warp leaves; no block-wide barrier follows
  const uint32_t chain = (uint32_t)chain_i;
  const int p = c.p, n = c.n_data, npad = (n + 31) / 32 * 32;
  const bool lik = c.lik != 0;
  const float* X = data;
  const float* Y = data + n;
  float* G = smem_all + (size_t)warp * warp_floats(p);  // the masked basis's Gram
  float* W1 = G + p * p;      // work matrices: H and L_h, S_birth and L_b, C_death and L_cd
  float* W2 = W1 + p * p;     // H, C_birth, S_death
  float* coef = W2 + p * p;   // a coefficient vector staged for the data loops
  float* coef2 = coef + 32;
  float* w = coef2 + 32;      // forward-solve results
  float* x = w + 32;          // back-substitution results
  float* w2 = x + 32;
  float* x2 = w2 + 32;
  float* dv = x2 + 32;        // batched data-row sums
  float* bas = scratch + (size_t)chain_i * (p + 3) * npad;  // p basis rows
  float* res = bas + (size_t)p * npad;  // the running residual
  float* row1 = res + npad;             // new column, dB, a walk's candidate column
  float* row2 = row1 + npad;            // B beta, a walk's column change

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
    const int ka = (int)kf;                  // active columns this sweep
    const int kb = ka + 1 < p ? ka + 1 : p;  // the birth's matrices
    const uint32_t words = sweep_words(c, chain, it, lane);

    if (lik) {
      // the basis and the residual y - B beta, rebuilt at the start of the sweep
      coef[lane] = beta;
      basis_rows(X, theta, omega, m, ka, n, bas, npad, lane);
      __syncwarp();
      fit_rows(bas, npad, n, ka, coef, res, lane);
      for (int r = lane; r < n; r += 32) res[r] = __ldg(Y + r) - res[r];
      __syncwarp();
    }

    // ==== 1. manifold MALA on beta =========================================
    bool acc;
    if (lik) {
      gram(bas, npad, n, p, ka, true, G, dv, lane);
      const float g = lane < ka ? (tau * dv[lane] - c.tau_b * (beta - c.mu_b)) * m : 0.0f;
      for (int j = 0; j < ka; ++j) {
        const float mj = __shfl_sync(kFull, m, j);
        float h = lane < ka ? tau * G[p * j + lane] * m * mj : 0.0f;
        if (lane == j) h = h + (c.tau_b * mj + (1.0f - mj));
        if (lane < ka) {
          W2[p * j + lane] = h;  // H, kept for H d_r
          W1[p * j + lane] = h;  // factored into L_h
        }
      }
      __syncwarp();
      chol(W1, p, ka, lane);
      forward(W1, p, ka, g, w, lane);
      const float z = normal(lane_bits(c, chain, it, 0, lane)) * m;
      w2[lane] = z;
      __syncwarp();
      back2(W1, p, ka, w, x, w2, x2, lane);
      const float hg = lane < ka ? x[lane] : 0.0f;
      const float ltz = x2[lane];
      const float mu_f = beta + c.half_s2 * hg;
      const float beta_prop = m > 0.0f ? mu_f + c.s_mmala * ltz : beta;
      const float delta = beta_prop - beta;
      const float d_r = beta - (beta_prop + c.half_s2 * (hg - delta));
      float hdr = 0.0f;
#pragma unroll 4
      for (int j = 0; j < ka; ++j) hdr = hdr + W2[p * j + lane] * __shfl_sync(kFull, d_r, j);
      const float q_r = jsum(d_r * hdr, ka);
      const float zz = jsum(z * z, ka);
      const float logq_diff = c.c_q * q_r + 0.5f * zz;
      __syncwarp();
      coef[lane] = delta;
      __syncwarp();
      fit_rows(bas, npad, n, ka, coef, row1, lane);  // dB
      const float s1 = row_dot(res, row1, n, lane), s2 = row_dot(row1, row1, n, lane);
      const float d_ll = tau * s1 - 0.5f * tau * s2;
      const float d_prior = jsum(
          m * (c.neg_half_tau_b * ((beta_prop - c.mu_b) * (beta_prop - c.mu_b) - (beta - c.mu_b) * (beta - c.mu_b))), ka);
      acc = logf(uniform_from_bits(single(c, words, 1))) < (d_prior + d_ll + logq_diff);
      if (acc) {
        beta = beta_prop;
        for (int r = lane; r < n; r += 32) res[r] = res[r] - row1[r];
      }
      __syncwarp();
    } else {
      const float z = normal(lane_bits(c, chain, it, 0, lane));
      const float mu_f = c.drift * beta + c.drift_c;
      const float beta_prop = m > 0.0f ? mu_f + c.sigma * z : beta;
      const float mu_r = c.drift * beta_prop + c.drift_c;
      const float a = (beta_prop - c.mu_b) * (beta_prop - c.mu_b) - (beta - c.mu_b) * (beta - c.mu_b);
      const float b = (beta - mu_r) * (beta - mu_r) - (beta_prop - mu_f) * (beta_prop - mu_f);
      const float dlp = jsum(m * (c.neg_half_tau_b * a - c.c_prop * b), ka);
      acc = logf(uniform_from_bits(single(c, words, 1))) < dlp;
      if (acc) beta = beta_prop;
    }
    acc_m = acc_m + (acc ? 1.0f : 0.0f);

    // ==== 2/3. truncated random walks on theta and omega ===================
    if (lik) {
      for (int pass = 0; pass < 2; ++pass) {  // theta's columns, then omega's
        // lane j's proposal for column j, its accept uniform's log and density
        // terms: each reads only its own column, which no earlier column changes
        float nv = 0.0f, lu = 0.0f, corr = 0.0f, dtarget = 0.0f;
        if (lane < ka) {
          const int s0 = 2 + 2 * p * pass + 2 * lane;
          const uint32_t bits = philox_word(c.seed, chain, it, (uint32_t)s0, 0u, 0u);
          lu = logf(uniform_from_bits(philox_word(c.seed, chain, it, (uint32_t)(s0 + 1), 0u, 0u)));
          if (pass == 0) {
            nv = truncnorm(theta, c.s_theta, c.th_lo, c.th_hi, bits);
            corr = tn_logpdf(theta, nv, c.s_theta, c.th_lo, c.th_hi) -
                   tn_logpdf(nv, theta, c.s_theta, c.th_lo, c.th_hi);
          } else {
            nv = truncnorm(omega, c.s_omega, c.om_lo, c.om_hi, bits);
            const float om_safe_c = omega > 0.0f ? omega : 1.0f, om_safe_p = nv > 0.0f ? nv : 1.0f;
            dtarget = c.a_om_m1 * (logf(om_safe_p) - logf(om_safe_c)) - c.b_om * (nv - omega);
            corr = tn_logpdf(omega, nv, c.s_omega, c.om_lo, c.om_hi) -
                   tn_logpdf(nv, omega, c.s_omega, c.om_lo, c.om_hi);
          }
        }
        for (int j = 0; j < ka; ++j) {  // a padded column's walk is never accepted
          const float bj = __shfl_sync(kFull, beta, j);
          const float th_j = __shfl_sync(kFull, theta, j), om_j = __shfl_sync(kFull, omega, j);
          const float nv_j = __shfl_sync(kFull, nv, j), lu_j = __shfl_sync(kFull, lu, j);
          const float corr_j = __shfl_sync(kFull, corr, j), dt_j = __shfl_sync(kFull, dtarget, j);
          const float th_c = pass == 0 ? nv_j : th_j, om_c = pass == 0 ? om_j : nv_j;
          float* col = bas + j * npad;
          float s1 = 0.0f, s2 = 0.0f;
          for (int r = lane; r < n; r += 32) {
            const float cn = basis_val(__ldg(X + r), th_c, om_c, 1.0f);
            const float dc = (cn - col[r]) * bj;
            row1[r] = cn;
            row2[r] = dc;
            s1 = s1 + res[r] * dc;
            s2 = s2 + dc * dc;
          }
          const float d_ll = tau * warp_tree(s1) - 0.5f * tau * warp_tree(s2);
          const float log_ratio = pass == 0 ? d_ll + corr_j : dt_j + d_ll + corr_j;
          bool acc_j = lu_j < log_ratio;
          if (pass == 1) acc_j = acc_j && nv_j > 0.0f;
          if (acc_j) {
            for (int r = lane; r < n; r += 32) {
              col[r] = row1[r];
              res[r] = res[r] - row2[r];
            }
            if (lane == j) {
              if (pass == 0) theta = nv;
              else omega = nv;
            }
          }
          if (pass == 0) acc_t = acc_t + (acc_j ? 1.0f : 0.0f);
          else acc_o = acc_o + (acc_j ? 1.0f : 0.0f);
        }
        if (pass == 0) prop_t = prop_t + kf;
        else prop_o = prop_o + kf;
      }
      __syncwarp();
    } else {
      {
        const float th_prop = truncnorm(theta, c.s_theta, c.th_lo, c.th_hi, lane_bits(c, chain, it, 2, lane));
        const float lf = tn_logpdf(th_prop, theta, c.s_theta, c.th_lo, c.th_hi);
        const float lr = tn_logpdf(theta, th_prop, c.s_theta, c.th_lo, c.th_hi);
        const bool a = logf(uniform_from_bits(lane_bits(c, chain, it, 3, lane))) < (lr - lf) && m > 0.0f;
        if (a) theta = th_prop;
        acc_t = acc_t + (float)__popc(__ballot_sync(kFull, a));
        prop_t = prop_t + kf;
      }
      {
        const float om_prop = truncnorm(omega, c.s_omega, c.om_lo, c.om_hi, lane_bits(c, chain, it, 4, lane));
        const float lf = tn_logpdf(om_prop, omega, c.s_omega, c.om_lo, c.om_hi);
        const float lr = tn_logpdf(omega, om_prop, c.s_omega, c.om_lo, c.om_hi);
        const float om_safe_c = omega > 0.0f ? omega : 1.0f, om_safe_p = om_prop > 0.0f ? om_prop : 1.0f;
        const float dtarget = c.a_om_m1 * (logf(om_safe_p) - logf(om_safe_c)) - c.b_om * (om_prop - omega);
        bool a = logf(uniform_from_bits(lane_bits(c, chain, it, 5, lane))) < (dtarget + lr - lf) && m > 0.0f;
        a = a && om_prop > 0.0f;
        if (a) omega = om_prop;
        acc_o = acc_o + (float)__popc(__ballot_sync(kFull, a));
        prop_o = prop_o + kf;
      }
      basis_rows(X, theta, omega, m, ka, n, bas, npad, lane);
      __syncwarp();
    }

    // ==== 4. reversible jump ===============================================
    const float u_move = uniform_from_bits(single(c, words, c.site_move));
    const bool birth = kf >= (float)p ? false : (kf <= 1.0f ? true : u_move <= 0.5f);
    const bool is_k = (float)lane == kf, lt_k = (float)lane < kf, lt_k1 = (float)lane < kf + 1.0f;

    // ---- birth: the new column and B beta, then the Gram and the birth's sums
    const float th_new = c.th_lo + c.th_range * uniform_from_bits(single(c, words, c.site_th_new));
    const float om_new = gamma_words(c.g_om, c.b_om, words, c.site_move);
    for (int r = lane; r < n; r += 32) row1[r] = basis_val(__ldg(X + r), th_new, om_new, 1.0f);
    const float log_new = -c.log_range_th + c.a_om_m1 * logf(om_new) - c.b_om * om_new + c.lgam_om;
    coef[lane] = beta;
    __syncwarp();
    fit_rows(bas, npad, n, ka, coef, row2, lane);  // B beta
    gram(bas, npad, n, p, ka, false, G, dv, lane);
    birth_dots(bas, npad, n, p, ka, dv, lane);
    const float ndot = lane < ka ? dv[lane] : 0.0f;
    const float nn = dv[ka];
    const float base_dot = lane < ka ? dv[ka + 1 + lane] : 0.0f;
    const float new_dot_r = dv[2 * ka + 1];
    const float nd_kk = is_k ? nn : ndot;
    for (int j = 0; j < kb; ++j) {  // S_birth into W1, C_birth into W2
      const bool j_k = (float)j == kf, j_lt1 = (float)j < kf + 1.0f, j_lt = (float)j < kf;
      const float nd_j = __shfl_sync(kFull, ndot, j);
      float v = is_k ? nd_j : G[p * j + lane];
      if (j_k) v = nd_kk;
      if (!(lt_k1 && j_lt1)) v = 0.0f;
      float cb = v;
      if (lane == j) {
        v = v + (j_lt1 ? kRidge : 1.0f);
        cb = v - (j_lt ? kRidge : 0.0f);
      }
      if (lane < kb) {
        W1[p * j + lane] = v;
        W2[p * j + lane] = cb;
      }
    }
    __syncwarp();
    float logdet_Sb, logdet_Cb;
    chol2(W1, W2, p, kb, lane, logdet_Sb, logdet_Cb);
    const float rhs = lt_k1 ? (is_k ? new_dot_r : base_dot) : 0.0f;
    forward(W1, p, kb, rhs, w, lane);
    back(W1, p, kb, w, x, lane);
    const float mu_star = x[lane];
    const int k_i = (int)kf;
    const float mu_k = __shfl_sync(kFull, mu_star, k_i & 31);
    const float mu_new = k_i < p ? mu_k : 0.0f;
    const float draw = truncnorm(mu_new, c.m_scale, c.m_lo, c.m_hi,
                                           single(c, words, c.site_draw));
    const float log_draw = tn_logpdf(draw, mu_new, c.m_scale, c.m_lo, c.m_hi);
    const float beta_birth = lt_k ? mu_star : (is_k ? draw : 0.0f);
    const float ld_F_birth = logdet_Cb - logdet_Sb;
    const float birth_fwd = logf(kf <= 1.0f ? 1.0f : 0.5f) + log_new + log_draw;
    const float birth_rev = logf(kf >= (float)(p - 1) ? 1.0f : 0.5f) + ld_F_birth;
    const float th_birth = is_k ? th_new : theta, om_birth = is_k ? om_new : omega;

    // ---- death
    const float u_del = uniform_from_bits(single(c, words, c.site_delete));
    const float jf = fminf(fmaxf(floorf(u_del * kf), 0.0f), fmaxf(kf - 1.0f, 0.0f));
    const int j_i = (int)jf;
    const bool is_j = (float)lane == jf;
    const float om_del = __shfl_sync(kFull, omega, j_i & 31);
    const float om_del_safe = om_del > 0.0f ? om_del : 1.0f;
    const float log_del = -c.log_range_th + c.a_om_m1 * logf(om_del_safe) - c.b_om * om_del_safe + c.lgam_om;
    float s_beta = 0.0f;
    for (int j = 0; j < ka; ++j) {  // S_death into W2, C_death into W1, S_death beta
      const bool j_lt = (float)j < kf;
      float v = (lt_k && j_lt) ? G[p * j + lane] : 0.0f;
      float cd = v;
      if (lane == j) {
        v = v + (j_lt ? kRidge : 1.0f);
        cd = v + kRidge * ((is_j ? 1.0f : 0.0f) - (lt_k ? 1.0f : 0.0f));
      }
      s_beta = s_beta + v * __shfl_sync(kFull, beta, j);
      if (lane < ka) {
        W2[p * j + lane] = v;
        W1[p * j + lane] = cd;
      }
    }
    __syncwarp();
    float logdet_Sd, logdet_Cd;
    chol2(W2, W1, p, ka, lane, logdet_Sd, logdet_Cd);
    forward(W1, p, ka, s_beta, w, lane);
    back(W1, p, ka, w, x, lane);
    const float mu_aug = x[lane];
    const float ld_F_death = logdet_Cd - logdet_Sd;
    const float param_del = __shfl_sync(kFull, mu_aug, j_i & 31);
    const float log_rev_draw = tn_logpdf(param_del, 0.0f, c.m_scale, c.m_lo, c.m_hi);
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
      coef[lane] = lt_k ? mu_star : 0.0f;
      coef2[lane] = (lt_k && !is_j) ? mu_aug : 0.0f;
      __syncwarp();
      float sb = 0.0f, sd = 0.0f;
      for (int r = lane; r < n; r += 32) {
        float fb = 0.0f, fd = 0.0f;
#pragma unroll 4
        for (int i = 0; i < ka; ++i) {
          const float bv = bas[i * npad + r];
          fb = fb + bv * coef[i];
          fd = fd + bv * coef2[i];
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
    acc = logf(uniform_from_bits(single(c, words, c.site_accept))) < log_accept;
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
      tau = gamma_words(c.g_tau, c.b_tau + 0.5f * quad_sel, words, c.site_move);
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
  const size_t smem = (size_t)kWarps * warp_floats(prm->p) * sizeof(float);
  rj_kernel<<<blocks, 32 * kWarps, smem, stream>>>(*prm, data, init, scratch, out);
  return (int)cudaGetLastError();
}
