// Device sampling functions over Philox bits: the CUDA counterpart of the TPU
// kernels' in-kernel random-number layer, openmcmc_tpu/fused/prng.py
// (uniform :178, normal_icdf :244, erfinv_poly :310, gamma_mt2 :262,
// gamma_mt :372, _mt_rounds :159, erf_poly :295, truncnorm_draw :339,
// truncnorm_logpdf :353, gamma_mt_elem :218).
//
// Every expression keeps the JAX function's operation order and float32
// constants, and the library is compiled with --fmad=false, so a kernel rounds
// like the plain PyTorch versions in openmcmc_tpu_torch/fused/prng.py; the
// remaining differences are the last-ulp behaviour of logf/sqrtf, not the
// algorithm.
#pragma once

#include "philox.cuh"

// U(0, 1) from the top 24 bits: (i + 0.5) / 2^24, never 0 or 1.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// Giles (2012) single-precision inverse-erf polynomial.
__device__ __forceinline__ float erfinv_poly(float t) {
  float w = -logf((1.0f - t) * (1.0f + t));
  bool small = w < 5.0f;
  float arg = small ? (w - 2.5f) : (sqrtf(fmaxf(w, 1e-30f)) - 3.0f);
  float p = small ? 2.81022636e-08f : -2.00214257e-04f;
  p = p * arg + (small ? 3.43273939e-07f : 1.00950558e-04f);
  p = p * arg + (small ? -3.5233877e-06f : 1.34934322e-03f);
  p = p * arg + (small ? -4.39150654e-06f : -3.67342844e-03f);
  p = p * arg + (small ? 2.1858087e-04f : 5.73950773e-03f);
  p = p * arg + (small ? -1.25372503e-03f : -7.62246130e-03f);
  p = p * arg + (small ? -4.17768164e-03f : 9.43887047e-03f);
  p = p * arg + (small ? 2.46640727e-01f : 1.00167406e00f);
  p = p * arg + (small ? 1.50140941e00f : 2.83297682e00f);
  return p * t;
}

// N(0, 1) by inverse CDF: sqrt(2) erfinv(2u - 1), 2u - 1 clamped to +-(1 - 1.2e-7).
__device__ __forceinline__ float normal_icdf_from_bits(uint32_t bits) {
  float u = uniform_from_bits(bits);
  float t = fminf(fmaxf(2.0f * u - 1.0f, -1.0f + 1.2e-7f), 1.0f - 1.2e-7f);
  return 1.41421356237309515f * erfinv_poly(t);
}

// Abramowitz-Stegun 7.1.26 erf polynomial (erf_poly :295). For huge |x| (an
// open bound of +-1e30 over a scale) ax * ax overflows to inf, expf gives 0 and
// the result saturates to +-1, as in the JAX function.
__device__ __forceinline__ float erf_poly(float x) {
  const float sgn = x < 0.0f ? -1.0f : 1.0f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sgn * (1.0f - poly * expf(-ax * ax));
}

// Inverse-CDF truncated-normal draw on [lo, hi] from one word of Philox bits
// (truncnorm_draw :339): clamped Giles inverse erf, clipped into the
// standardized bounds and then into [lo, hi].
__device__ __forceinline__ float truncnorm_from_bits(float mu, float scale, float lo, float hi, uint32_t bits) {
  const float a = (lo - mu) / scale;
  const float b = (hi - mu) / scale;
  const float ea = erf_poly(a * 0.707106781186547573f);
  const float eb = erf_poly(b * 0.707106781186547573f);
  const float u = uniform_from_bits(bits);
  const float t = ea + u * (eb - ea);
  float z = 1.41421356237309515f * erfinv_poly(fminf(fmaxf(t, -1.0f + 1e-7f), 1.0f - 1e-7f));
  z = fminf(fmaxf(z, a), b);
  return fminf(fmaxf(mu + scale * z, lo), hi);
}

// Truncated-normal log-density on [lo, hi] (truncnorm_logpdf :353): the
// polynomial-erf box mass clamped at 1e-30, and -inf outside [lo, hi].
__device__ __forceinline__ float truncnorm_logpdf(float x, float mu, float scale, float lo, float hi) {
  const float a = (lo - mu) / scale;
  const float b = (hi - mu) / scale;
  const float z = (x - mu) / scale;
  const float mass = 0.5f * (erf_poly(b * 0.707106781186547573f) - erf_poly(a * 0.707106781186547573f));
  const float dens = -0.5f * (z * z + 1.83787706640934534f) - logf(scale) - logf(fmaxf(mass, 1e-30f));
  return (x >= lo && x <= hi) ? dens : __int_as_float(0xff800000);  // -inf
}

// One Marsaglia-Tsang Gamma draw as the TPU kernels make it: a fixed number of
// squeeze rounds (a miss keeps the initial d), and for shape < 1 the boost
// G(a) = G(a + 1) U^(1/a). The host fills the spec exactly as the JAX function
// computes it (openmcmc_tpu_torch/fused/prng.py: gamma_pair_specs).
struct GammaSpec {
  float d;      // a - 1/3, with a the (boosted) Marsaglia-Tsang shape
  float c;      // 1 / sqrt(9 d)
  float a;      // the requested shape, read only by the boost
  int32_t rounds;
  int32_t boost;  // 1 when the requested shape is < 1
  int32_t site0;  // draw site of round 0's normal; round r uses site0 + 2r and +1
  int32_t elem;   // element of the site's Philox block (0 lam, 1 tau jointly)
};

// The draw on the words of its sites: word(site) is element g.elem's Philox
// word of that site (gamma_draw reads them from Philox; a caller that holds them
// already passes them in).
template <class Word>
__device__ __forceinline__ float gamma_from_words(const GammaSpec& g, float rate, Word word) {
  const float d = g.d, c = g.c;
  float value = d;
  for (int r = 0; r < g.rounds; ++r) {
    float x = normal_icdf_from_bits(word(g.site0 + 2 * r));
    float t = 1.0f + c * x;
    float v = t * (t * t);
    float u = uniform_from_bits(word(g.site0 + 2 * r + 1));
    bool ok = v > 0.0f &&
              logf(u) < 0.5f * x * x + d - d * v + d * logf(v > 0.0f ? v : 1.0f);
    if (ok) {
      value = d * v;
      break;  // later rounds could not change an accepted value
    }
  }
  if (g.boost) {
    float u = uniform_from_bits(word(g.site0 + 2 * g.rounds));
    return value / 1.0f * expf(logf(u) / g.a) / rate;
  }
  return value / rate;
}

__device__ __forceinline__ float gamma_draw(const GammaSpec& g, float rate, uint32_t seed,
                                            uint32_t chain, uint32_t sweep) {
  return gamma_from_words(g, rate, [&](int site) { return site_block(seed, chain, sweep, (uint32_t)site, 0u).x[g.elem]; });
}

// Marsaglia-Tsang Gamma(a_star) / rate with an elementwise shape a_star >= 1
// (gamma_mt_elem :218): GAMMA_ROUNDS = 6 fixed rounds, no shape < 1 boost, and
// the value d when no round accepts. Round r reads its normal from site
// site0 + 2r and its uniform from site0 + 2r + 1, element elem of each
// (Philox block elem / 4, word elem % 4). d and c are computed here in float32
// from a_star, as the JAX function does; a round after an accepted one cannot
// change the value, so the loop stops there.
__device__ __forceinline__ float gamma_mt_elem(float a_star, float rate, uint32_t seed, uint32_t chain,
                                               uint32_t sweep, uint32_t site0, uint32_t elem) {
  const float d = a_star - 1.0f / 3.0f;
  const float c = 1.0f / sqrtf(9.0f * d);
  float value = d;
  for (int r = 0; r < 6; ++r) {
    const Philox4 nb = site_block(seed, chain, sweep, site0 + 2u * r, elem / 4u);
    const Philox4 ub = site_block(seed, chain, sweep, site0 + 2u * r + 1u, elem / 4u);
    const float x = normal_icdf_from_bits(nb.x[elem % 4u]);
    const float t = 1.0f + c * x;
    const float v = t * (t * t);
    const float u = uniform_from_bits(ub.x[elem % 4u]);
    const bool ok = v > 0.0f && logf(u) < 0.5f * x * x + d - d * v + d * logf(v > 0.0f ? v : 1.0f);
    if (ok) {
      value = d * v;
      break;
    }
  }
  return value / rate;
}
