"""Smoke test of the PyTorch/CUDA port (openmcmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in openmcmc_tpu_torch/csrc,
holds each kernel against its plain PyTorch version on the card, and drives the
flagship smoother (bench.py's model: p = 100 RW1 GMRF, 8192 chains, 200 burn-in
and 500 stored sweeps) through both of the port's paths:

- ``MCMC(...).run(engine="auto")``, the fused path: one launch of the
  spectral-smoother kernel (K1), which writes each stored w, and one of the
  store kernel, which turns the stored rows into b = V w in place, its draws
  held against the plain version; the two kernels are then timed apart, by
  CUDA events and by the profiler;
- ``MCMC(...).run(engine="generic")``, the generic driver: one launch of the
  canonical tridiagonal kernel (K3) per sweep, its posterior means held against
  the fused run's within the Monte Carlo bound.

Before them ``tridiag`` holds K3 against its plain version at (8192, 100),
(1000, 4099) and (4096, 4096), counting the values equal bit for bit, and on a
forced IEEE rerun bit for bit, and times the kernel alone and through its
wrapper at the shapes of the generic flagship and of ``thomas_long``'s twin.

Then the two paths ``engine="auto"`` takes to the Thomas-scan kernel (K4), each
through ``MCMC.run(engine="auto")`` with one K4 launch, held against K4's plain
version and, in posterior means, against the generic driver:

- ``truncated``: bench_all.py's box-truncated smoother (p = 100 RW1 prior with
  b in [0, 3.5], 4096 chains, 100 burn-in and 250 stored sweeps), engine
  ``fused_gmrf_smoother_truncated``;
- ``thomas_long``: the flagship model at p = 4096 (0.6 s spacing, 4096 chains,
  200 burn-in and 100 stored sweeps), engine ``fused_gmrf_smoother``.

Then linear regression, each configuration through ``MCMC.run(engine="auto")``
with one launch of its kernel, that kernel held against its plain version on a
short run at full width, and its posterior means of beta, tau and log lambda
held against the generic driver's (the dense NormalNormal step, no kernel):

- ``linreg``: the reference's example 3 as bench_all.py builds it (N = 100,
  p = 2, Gamma(1e-3, 1e-3) scales, 4096 chains, 1000 burn-in and 1000 stored
  sweeps), engine ``fused_linreg``, the unrolled-Cholesky kernel (K6);
- ``linreg_wide``: the spectral engine at its limit (N = 2048, p = 256,
  Gamma(1, 1) scales, 4096 chains, 200 burn-in and 500 stored sweeps), engine
  ``fused_linreg_spectral``, the spectral linear-regression kernel (K5), which
  writes each stored w, and the store kernel, which turns the stored rows into
  beta = V w in place (one launch each; lam, tau and log_post bit for bit on
  the check, the beta values that differ counted, the two kernels timed apart).

Then the Metropolis family, each cell through ``MCMC.run(engine="auto")`` with
one launch of its kernel, that kernel held against its plain version on a short
run at full width (the chains bit-identical counted), and its posterior means
held against a generic twin's (the port's RandomWalk or ManifoldMALA, no
kernel) and, where there is one, the analytic posterior:

- ``rw``: the reference's example 2 as bench_all.py builds it (y = [150, 155,
  190, 160, 173], h0 = 200, RandomWalk step 5, 8192 chains, no burn-in, 1000
  stored sweeps), engine ``fused_random_walk``, the random-walk kernel (K7);
- ``rw_box``: K7 at its limit, p = 32, truncated proposals on [-10, 10] with
  per-dimension steps and adaptation (4096 chains, 500 burn-in and 1000 stored
  sweeps), engine ``fused_random_walk``;
- ``mmala``: bench_all.py's mMALA regression (N = 100, p = 5, 4096 chains, 200
  burn-in and 1000 stored sweeps), engine ``fused_mmala``, the mMALA kernel (K8);
- ``mmala_wide``: the spectral mMALA engine at its limit (N = 2048, p = 256,
  adaptation, 4096 chains, 200 burn-in and 500 stored sweeps), engine
  ``fused_mmala_spectral``, the spectral mMALA kernel (K9) and the store kernel,
  as in ``linreg_wide`` (log_post, accept decisions, accept_total and log_step
  bit for bit). Then ``spectral_store`` holds the store kernel alone against
  the plain product on the w rows of a whole ``linreg_wide`` run and times it
  beside ``torch.matmul``.

Then the Gaussian mixture, each cell through ``MCMC.run(engine="auto")`` with
one launch of the mixture kernel (K10), that kernel held against its plain
version on a short run at full width, and the posterior means of the sorted
component means and their precisions held against a generic twin's (the
port's MixtureAllocation, RandomWalkLoop or NormalNormal and NormalGamma, no
kernel); before them ``gamma_elem`` holds K10's elementwise Gamma device
function against its plain version, and ``mixture_small`` K10 against its plain
version on every value and every stored allocation, on both variants, K = 2 and
16, n = 200 and 3000:

- ``mixture``: bench_all.py's mixture (n = 200, K = 2, RandomWalkLoop step 0.3
  on [-20, 20]^2, 4096 chains, 500 burn-in and 1000 stored sweeps), engine
  ``fused_mixture``; run once more with the default store set (the allocation
  Z included, 3.3 GB), whose log_post must equal ``Model.log_p`` at the stored
  (Z, means, lams);
- ``mixture_conjugate``: the same model with conjugate means, engine
  ``fused_mixture_conjugate``;
- ``mixture_large``: bench_all.py's streamed-scale mixture (n = 100,000,
  K = 16, conjugate means, 256 chains, 50 burn-in and 150 stored sweeps),
  engine ``fused_mixture_conjugate``.

Then reversible jump, each cell through ``MCMC.run(engine="auto")`` with one
launch of the reversible-jump kernel (K11), that kernel held against its plain
version on every chain of a 5-sweep run at full width with the parameters
streamed, and a generic twin (the port's ManifoldMALA, RandomWalkLoop,
ReversibleJump and NormalGamma, no kernel); before them ``rj_small`` holds K11
against its plain version on both variants at n_max 2 to 32, n_data 7 to 1000,
and at full width (n_max 20, n_data 50, 2048 chains) from warm rows whose counts
spread over 1..20. Each cell's main path runs three times (the same draws), and
K11's time is the median of the three:

- ``rj``: bench_all.py's reversible_jump (the prior-recovery configuration:
  Null likelihood, n_max 20, 50 points, rho 8, 2048 chains, 5000 stored
  sweeps), engine ``fused_rj``; its count marginal, thinned by 10, against the
  [1, 20]-truncated Poisson(8) (mean within 0.25, sd within 0.35), and the
  generic twin's against the same target within 5 Monte Carlo sd;
- ``rj_regression``: bench_all.py's reversible_jump_regression (y ~ N(B beta,
  (tau_y I)^-1) with a conjugate tau_y, 2048 chains, 5000 stored sweeps),
  engine ``fused_rj``; a streamed run whose log_post equals ``Model.log_p`` at
  the stored draws, and the posterior means of the count and tau_y after the
  first 1000 draws against the generic twin's within 5 Monte Carlo sd.

Each path runs with every launch count set to 0 just before it and read just
after. The kernels are timed against their plain versions with CUDA events,
beside the least time the card could take for the same work (``bound_ms``).
Every phase raises on failure; the script exits non-zero and prints no result
when there is no CUDA device. It imports nothing of JAX.

Output: one line per phase; then the card's name and power limit as nvidia-smi
reports them; then one JSON line with the kernels' results; and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_TIME, N_CHAINS, N_BURN, N_ITER, SEED = 100, 8192, 200, 500, 7
DEVICE_TYPE = "cuda"
REPLACES = {
    "spectral_smoother": "openmcmc_tpu/fused/spectral.py:319",
    "prng_draws": "openmcmc_tpu/fused/prng.py:178",
    "tridiag_canonical": "openmcmc_tpu/linalg/pallas_tridiag.py:43",
    "gmrf_smoother": "openmcmc_tpu/fused/gmrf_smoother.py:58",
    "truncnorm_draws": "openmcmc_tpu/fused/prng.py:339",
    "linreg": "openmcmc_tpu/fused/linreg.py:50",
    "spectral_linreg": "openmcmc_tpu/fused/spectral.py:94",
    "random_walk": "openmcmc_tpu/fused/random_walk.py:46",
    "mmala": "openmcmc_tpu/fused/mmala.py:49",
    "spectral_mmala": "openmcmc_tpu/fused/spectral.py:655",
    # the stores inside K5 and K9: their block products w V' on the MXU (:174-177, :755-758)
    "spectral_store": "openmcmc_tpu/fused/spectral.py:174",
    "mixture": "openmcmc_tpu/fused/mixture.py:107",
    "gamma_elem_draws": "openmcmc_tpu/fused/prng.py:218",
    "rj": "openmcmc_tpu/fused/rj.py:_make_kernel",
    "gamma": "openmcmc_tpu/linalg/pallas_gamma.py:39",
}
# the K4 cells: bench_all.py's truncated_smoother (bench_all.py:468, :762) and the
# flagship model past the spectral engine's tridiagonal limit (p > 1024)
T_CHAINS, T_BURN, T_ITER, T_SEED, T_BOX = 4096, 100, 250, 0, (0.0, 3.5)
L_P, L_CHAINS, L_BURN, L_ITER = 4096, 4096, 200, 100
L_GEN_BURN, L_GEN_ITER = 50, 100  # thomas_long's generic (K3) run: exact redraws need little burn-in
# the linear-regression cells: example 3 (bench_all.py:97-117, fused row :564-570)
# and the spectral engine at p = 256; their generic twins run fewer sweeps (and,
# at p = 256, fewer chains: the dense step factors a 256 x 256 matrix per chain)
R_N, R_CHAINS, R_BURN, R_ITER, R_SEED = 100, 4096, 1000, 1000, 3
R_GEN_BURN, R_GEN_ITER = 200, 300
W_N, W_P, W_CHAINS, W_BURN, W_ITER, W_SEED = 2048, 256, 4096, 200, 500, 7
W_GEN_CHAINS, W_GEN_BURN, W_GEN_ITER = 256, 50, 150
# the Metropolis cells: example 2 (bench_all.py:120-126, fused row :598-601), K7 at
# p = 32 with a box and adaptation, the mMALA regression (bench_all.py:129-144,
# fused row :593-594) and K9 at p = 256; their generic twins run fewer chains
# (rw_box, mmala_wide) and fewer sweeps (mmala, mmala_wide). rw_box's twin keeps
# the cell's sweeps: from h0 = 0 its joint walk needs about 400 sweeps to reach
# the posterior, so a shorter twin would compare two different transients
RW_Y, RW_CHAINS, RW_ITER = (150.0, 155.0, 190.0, 160.0, 173.0), 8192, 1000
B_P, B_N, B_CHAINS, B_BURN, B_ITER, B_SEED = 32, 20, 4096, 500, 1000, 1
B_GEN_CHAINS, B_GEN_BURN, B_GEN_ITER = 1024, 500, 1000
M_N, M_P, M_CHAINS, M_BURN, M_ITER = 100, 5, 4096, 200, 1000
M_GEN_BURN, M_GEN_ITER = 200, 300
MW_N, MW_P, MW_CHAINS, MW_BURN, MW_ITER, MW_SEED = 2048, 256, 4096, 200, 500, 7
MW_GEN_CHAINS, MW_GEN_BURN, MW_GEN_ITER = 256, 50, 150
# the mixture cells: bench_all.py's mixture (:284-323) and mixture_conjugate
# (:327-367) at their fused rows' width (:616-649), and mixture_large (:407-461);
# their generic twins run fewer chains and fewer sweeps (the generic sweep is
# launch-bound, so its time follows the sweeps)
X_N, X_K, X_CHAINS, X_BURN, X_ITER, X_GEN_CHAINS = 200, 2, 4096, 500, 1000, 1024
XL_N, XL_K, XL_CHAINS, XL_BURN, XL_ITER, XL_GEN_CHAINS = 100_000, 16, 256, 50, 150, 64
X_GEN_BURN, X_GEN_ITER, XL_GEN_BURN, XL_GEN_ITER = 200, 400, 50, 75
# the reversible-jump cells: bench_all.py's reversible_jump (:180-224, fused row
# :604-613) and reversible_jump_regression (:226-282, fused row :709-716), at
# their published width; their generic twins run 256 chains and fewer sweeps
J_MAX, J_N, J_CHAINS, J_ITER, J_GEN_CHAINS = 20, 50, 2048, 5000, 256
J_GEN_BURN, J_GEN_ITER = 100, 400  # rj's twin
JR_GEN_BURN, JR_GEN_ITER, JR_SKIP = 200, 300, 1000  # rj_regression's twin; the fused draws it skips
J_RUNS = 3  # main-path runs of each reversible-jump cell; K11's time is their median
J_PER_K, J_PER_K_SWEEPS = (2, 8, 16), 20  # K11's time per sweep from a fixed count
# H100 SXM data sheet: HBM bandwidth and the float32 rate outside the tensor cores
# (TF32 is excluded: the port keeps full float32, ROADMAP.md's invariant)
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
# float32 operations counted from the kernel sources (transcendentals, square
# roots and divisions one each; Philox's integer rounds are not counted)
K1_FLOP_PER_COORD = 49   # csrc/spectral_smoother.cu: inverse-CDF normal 30, w draw 12, quadratic forms 7
K1_FLOP_PER_SWEEP = 100  # the (lam, tau) Gamma pair, one Marsaglia-Tsang round each, and the rates
K1_FLOP_PER_STORE = 30   # the analytic log posterior; the store adds 2 p^2 for b = V w
K2_FLOP_PER_ROW = 222    # csrc/prng_draws.cu: 4 uniforms, 4 inverse-CDF normals, a Gamma pair
K3_FLOP_PER_ELEM = 21    # csrc/tridiag_canonical.cu: Box-Muller 9, forward step 8, back step 4
K4_FLOP_PER_THOMAS_ROW = 63  # csrc/gmrf_smoother.cu: inverse-CDF normal 30, forward step 16, back step 5, quadratic forms 12
K4_FLOP_PER_TRUNC_ROW = 105  # truncated draw 92 (its erf pair 36, inverse erf 24), quadratic forms 13
K4_FLOP_PER_SWEEP = 100      # the lam and the tau Gamma draw, one Marsaglia-Tsang round each, and the rates
K4_FLOP_PER_STORE = 30       # the analytic log posterior
K2T_FLOP_PER_ROW = 380       # csrc/prng_draws.cu truncnorm_draws: 4 erf_poly (17 each) and 4 truncated draws (78 each)
K6_FLOP_PER_NORMAL = 30      # csrc/linreg.cu: one inverse-CDF normal per coefficient
K6_FLOP_PER_SWEEP = 100      # the tau and the lam Gamma draw, one Marsaglia-Tsang round each, and the rates
K6_FLOP_PER_STORE = 30       # the analytic log posterior
K5_FLOP_PER_COORD = 47       # csrc/spectral_linreg.cu: inverse-CDF normal 30, w draw 9, the three sums 8
K5_FLOP_PER_SWEEP = 110      # the (tau, lam) Gamma pair, one round each, the rates and q_tau
K5_FLOP_PER_STORE = 30       # the analytic log posterior; the store adds 2 p^2 for beta = V w
K7_FLOP_PER_COORD = 47       # csrc/random_walk.cu: inverse-CDF normal 30, proposal 3, log-density terms 14
K7_FLOP_PER_TRUNC_COORD = 195  # truncated draw 78, two truncnorm_logpdf 51 each, their sums 2, the rest 15
K7_FLOP_PER_SWEEP = 20       # the accept uniform, its log and test, the Robbins-Monro nudge
K8_FLOP_PER_SWEEP = 30       # csrc/mmala.cu: the accept, the adapted step's constants
K9_FLOP_PER_COORD = 55       # csrc/spectral_mmala.cu: inverse-CDF normal 30, proposal 6, the four sums 19
K9_FLOP_PER_SWEEP = 40       # the totals, target, both proposal densities, accept and nudge
K9_FLOP_PER_STORE = 2        # the store adds 2 p^2 for beta = V w
K10_FLOP_PER_POINT_COMP = 15  # csrc/mixture.cu: the log-likelihood 9, max 1, exp and its argument 2, tot 1, cum 2
K10_FLOP_PER_POINT = 8        # the uniform and its scaling, cnt / 2, the four partial sums
K10_FLOP_PER_COMP = 120       # per sweep: the means update, one Gamma round, the log-posterior terms and sums
K2G_FLOP_PER_ROW = 240        # csrc/prng_draws.cu gamma_elem_draws: 4 gamma_mt_elem, one round each (60)
# csrc/gamma.cu per draw, counting what the draw needs: the shape set-up 7; each
# round up to the first acceptance 35 (three uniforms 9, the Box-Muller normal 6,
# t and the cube 4, the squeeze's right side 10, log u and the test 3, the select
# and the flag 3; later rounds do not change the draw); the boost where a < 1 7
# (its uniform, 1/a, powf, the product and the select)
K12_FLOP_SETUP, K12_FLOP_PER_ROUND, K12_FLOP_BOOST = 7, 35, 7
# the gamma and resume phases: K12's batch (a one-shot prior-predictive draw, the
# use the JAX docstring gives K12) and the short runs the resumes continue
G_N, G_KS, G_SHAPES = 1 << 24, 1_000_000, (0.3, 0.5, 1.0, 2.5, 10.0, 50.5, 500.0)
RS_CHUNKS, RS_SHORT, RS_GEN_CHAINS, RS_GEN_ITER = 5, 10, 1024, 500


def k6_flop_per_sweep(p):
    """K6's float32 operations per chain and sweep, counted from csrc/linreg.cu:
    the normals, the unrolled Cholesky, both triangular solves, the two
    quadratic forms and the Gamma draws."""
    chol = sum(4 + 2 * j + (p - 1 - j) * (2 + 2 * j) for j in range(p))
    solves = sum(4 + 2 * i for i in range(p)) + sum(2 + 2 * (p - 1 - i) for i in range(p))
    return K6_FLOP_PER_NORMAL * p + chol + solves + (3 + 3 * p) * p + 4 * p + K6_FLOP_PER_SWEEP


def k8_flop_per_sweep(p):
    """K8's float32 operations per chain and sweep, counted from csrc/mmala.cu:
    the normals, the back substitution (p^2), both proposal means and the
    proposal (8p), the target (3p^2 + 2p + 4), the two proposal densities
    (3p(p + 1) + 4p + 8) and the accept."""
    return 30 * p + p * p + 8 * p + 3 * p * p + 2 * p + 4 + 3 * p * (p + 1) + 4 * p + 8 + K8_FLOP_PER_SWEEP


def chol_flop(m):
    """Float32 operations of a Cholesky of an m x m matrix, lower triangle only:
    column j's m - j entries take j multiply-adds each and its m - j - 1
    subdiagonal entries one division; a pivot takes max, sqrt, log and the
    log-determinant's multiply-add (5)."""
    return (m ** 3 - m) / 3 + m * (m - 1) / 2 + 5 * m


def rj_flop_per_sweep(k, n_max, n_data, lik):
    """K11's float32 operations for one chain's sweep that starts with k active
    columns (k may be an array), counting what the sweep needs rather than what
    the kernel's lanes do: every vector, basis column, Gram, factorization and
    solve at the active size (k, or k + 1 for the birth's matrices), lower-triangle
    Choleskys (chol_flop), forward plus back substitution 2 m^2, and the one move
    the sweep makes at its probability (birth certain at k <= 1, impossible at
    n_max, else one half); transcendentals one each, Philox's integer rounds not
    counted. Both variants: the basis (8 k n), the Gram (k (k + 1) n), two model
    densities (30 k) and the accept (11); the birth: the new knot and its
    column (70 + 8 n), its dots (2 k n + 2 n), S and C (2 k + 1), two
    factorizations of k + 1, B beta and its dots (4 k n + 2 n), the solve, the
    matched draw and its density (129) and the proposal terms (23); the death:
    the index and log density (12), S and C (3 k), S beta (2 k^2), two
    factorizations of k, the solve, the reverse draw's density (51) and the
    proposal terms (6). Null variant: the mMALA step (51 k + 3) and the two
    vectorised walks (400 k). Likelihood variant: the residual (2 k n + n), the
    metric's Gram (k (k + 1) n), the gradient (2 k n + 4 k), the metric and its
    factorization (k (k + 1) / 2 + k + chol_flop(k)), its solve and back
    substitution (3 k^2), the proposal and its terms (43 k + 3), H d_r (2 k^2),
    dB and its two dots (2 k n + 4 n), the prior difference (10 k + 7), the 2 k
    column walks (383 k + 28 k n in all), the current quadratic (2 n), the
    move's proposed quadratic (birth 2 k n + 6 n, death 2 (k - 1) n + 3 n),
    the two log likelihoods (10) and tau's Gamma round with the log posterior
    (80). An accepted move that updates the residual adds n: counted by
    rj_flop from the run's accept counts."""
    k = np.asarray(k, dtype=np.float64)
    n = float(n_data)
    p_birth = np.where(k <= 1, 1.0, np.where(k >= n_max, 0.0, 0.5))
    birth = (70 + 8 * n + 2 * k * n + 2 * n + 2 * k + 1 + 2 * chol_flop(k + 1) + 4 * k * n + 2 * n
             + 2 * (k + 1) ** 2 + 129 + 23)
    death = 12 + 3 * k + 2 * k * k + 2 * chol_flop(k) + 2 * k * k + 51 + 6
    flop = 8 * k * n + k * (k + 1) * n + 30 * k + 11 + p_birth * birth + (1 - p_birth) * death
    if lik:
        flop = flop + (2 * k * n + n + k * (k + 1) * n + 2 * k * n + 4 * k + k * (k + 1) / 2 + k + chol_flop(k)
                       + 3 * k * k + 43 * k + 3 + 2 * k * k + 2 * k * n + 4 * n + 10 * k + 7 + 383 * k + 28 * k * n
                       + 2 * n + p_birth * (2 * k * n + 6 * n) + (1 - p_birth) * (2 * (k - 1) * n + 3 * n) + 10 + 80)
    else:
        flop = flop + 51 * k + 3 + 400 * k
    return flop


def rj_flop(k_start, n_max, n_data, lik, accepts=0):
    """K11's float32 operations over a run: rj_flop_per_sweep summed over every
    chain's sweeps, ``k_start`` the active count at the start of each (an integer
    array of chains x sweeps), plus n per accepted residual update (``accepts``:
    the run's accepted mMALA steps and column walks, likelihood variant)."""
    per_k = rj_flop_per_sweep(np.arange(n_max + 1), n_max, n_data, lik)
    counts = np.bincount(np.asarray(k_start, dtype=np.int64).reshape(-1), minlength=n_max + 1)
    return float(counts @ per_k) + (float(n_data) * float(accepts) if lik else 0.0)


def bound(n_bytes, n_flop):
    """The least time (ms) the card could take: bytes over HBM bandwidth or
    float32 operations over the peak rate, whichever is larger, and which."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * n_flop / PEAK_FP32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


START = time.perf_counter()


def log(phase, msg):
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - START:.1f} s] {msg}", flush=True)


def cuda_call_ms(fn):
    """fn's result and the milliseconds of the call, timed with CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms(fn, reps):
    """Median milliseconds of ``reps`` calls of fn, each timed with CUDA events."""
    return statistics.median(cuda_call_ms(fn)[1] for _ in range(reps))


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()}")
    return smi


def build_phase():
    from openmcmc_tpu_torch import _build

    built = _build.build()
    _build.library()
    log("build", f"nvcc {built.seconds:.1f} s, {built.path.name}")
    for ln in built.log.splitlines():
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln:
            log("build", ln.strip())


def prng_phase(dev):
    """prng_draws against draws_plain over the main path's normal-draw counters."""
    from openmcmc_tpu_torch.fused import prng

    chain = torch.arange(N_CHAINS, dtype=torch.int64).repeat_interleave((N_TIME + 3) // 4)
    group = torch.arange((N_TIME + 3) // 4, dtype=torch.int64).repeat(N_CHAINS)
    ctr = torch.stack([chain, torch.full_like(chain, 3), torch.zeros_like(chain), group], 1)
    ctr = ctr.to(torch.int32).to(dev).contiguous()
    worst = 0.0
    for a1, a2 in ((10.0 + N_TIME / 2, 1.0 + N_TIME / 2), (0.5, 2.5)):
        got = prng.draws(SEED, ctr, a1, a2, 2.0, 0.5)
        want = prng.draws_plain(SEED, ctr, a1, a2, 2.0, 0.5)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError("prng_draws: uniforms differ from the plain version")
        for name, g, w in (("normals", got[1], want[1]), ("gammas", got[2], want[2])):
            if not bool(torch.all(torch.isfinite(g))):
                raise AssertionError(f"prng_draws: non-finite {name}")
            rel = float(torch.max(torch.abs(g - w) / torch.clamp(torch.abs(w), min=1.0)))
            if rel > 1e-6:
                raise AssertionError(f"prng_draws: {name} differ by {rel:.3g} (relative) at shapes ({a1}, {a2})")
            worst = max(worst, float(torch.max(torch.abs(g - w))))
        log("prng", f"shapes ({a1}, {a2}): {ctr.shape[0]} rows, uniforms exact, normals/gammas within 1e-6 rel; "
            f"normal mean {float(got[1].mean()):+.4f} sd {float(got[1].std()):.4f}; "
            f"gamma means {[round(float(v), 4) for v in got[2].mean(0)]}")
    a1, a2 = 10.0 + N_TIME / 2, 1.0 + N_TIME / 2
    prng.draws(SEED, ctr, a1, a2)  # warm-up
    ms = cuda_ms(lambda: prng.draws(SEED, ctr, a1, a2), 5)
    plain_ms = cuda_ms(lambda: prng.draws_plain(SEED, ctr, a1, a2), 3)
    n = ctr.shape[0]
    bound_ms, bound_by = bound(n * (16 + 16 + 16 + 8), n * K2_FLOP_PER_ROW)
    log("prng", f"time at {n} rows: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def rw1_p0(p, ridge):
    from openmcmc_tpu_torch.linalg import gmrf, structured as st

    s = np.linspace(0.0, 60.0, p)
    P0 = gmrf.precision_irregular(s)
    bands = P0.bands.clone()
    bands[0, 0] += ridge
    return s, st.Banded(bands)


def lattice_p0(side):
    d = np.diag(np.ones(side - 1), 1) + np.diag(np.ones(side - 1), -1)
    lap = 4.0 * np.eye(side * side) - np.kron(np.eye(side), d) - np.kron(d, np.eye(side))
    return lap + 0.01 * np.eye(side * side)


def kernel_inputs(dev, y, P0, n_chains, noise=None, mu0=None, logdet_p0=None, lam0=100.0, tau0=1.0):
    from openmcmc_tpu_torch.fused import spectral

    prep = spectral.prepare(y, P0, noise_diag=noise, mu0=mu0, logdet_p0=logdet_p0)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "s", "wy", "wmu")]
    args += [torch.full((n_chains,), lam0, **f32), torch.full((n_chains,), tau0, **f32)]
    kw = dict(logdet_p0=float(np.float32(prep["logdet_p0"])), logdet_d=float(np.float32(prep["logdet_d"])))
    return args, kw


def equal_chains(got, want, names):
    """Chains whose every value of ``names`` equals the other output's bit for bit."""
    ok = None
    for name in names:
        same = (got[name] == want[name]).reshape(got[name].shape[0], -1).all(1)
        ok = same if ok is None else ok & same
    return int(ok.sum())


def compare(got, want, draw="b"):
    """Per-chain agreement of two engine outputs; returns (agreeing chains, max abs err)."""
    ok = torch.ones(got["lam"].shape[0], dtype=torch.bool, device=got["lam"].device)
    err = 0.0
    for name in (draw, "lam", "tau"):
        g, w = got[name], want[name]
        close = torch.isclose(g, w, rtol=1e-4, atol=1e-5).reshape(g.shape[0], -1).all(1)
        ok &= close
        err = max(err, float(torch.max(torch.abs(g - w))))
    lp_g, lp_w = got["log_post"], want["log_post"]
    ok &= (torch.abs(lp_g - lp_w) <= 1e-4 * torch.clamp(torch.abs(lp_w), min=1.0)).all(1)
    return int(ok.sum()), err


def spectral_small_phase(dev):
    """The kernel against the plain version on the same Philox bits, every value."""
    from openmcmc_tpu_torch.fused import spectral
    from openmcmc_tpu_torch.linalg import structured as st

    rng = np.random.default_rng(0)
    s, P0 = rw1_p0(N_TIME, 1e-3)
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + rng.normal(0.0, 1.0, N_TIME)
    cases = [
        ("rw1 p=100", y, st.to_dense(P0).numpy(), {}, 256),
        ("lattice p=400", rng.normal(size=400), lattice_p0(20),
         dict(noise=rng.uniform(0.5, 2.0, 400), mu0=0.1 * rng.normal(size=400)), 64),
    ]
    hyp = dict(a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=3, n_keep=5, n_thin=2)
    for name, yy, PP, extra, chains in cases:
        args, kw = kernel_inputs(dev, yy, PP, chains, **extra)
        got = spectral.smoother_sweeps_kernel(11, *args, **kw, **hyp)
        want = spectral.smoother_sweeps_plain(11, *args, **kw, **hyp)
        torch.cuda.synchronize()
        agree, err = compare(got, want)
        if agree != chains:
            raise AssertionError(f"spectral kernel, {name}: {chains - agree} of {chains} chains differ from plain")
        log("spectral", f"{name}, {chains} chains, n_burn=3 n_iter=5 n_thin=2: all values agree "
            f"(rtol 1e-4), max abs err {err:.3g}")


def smoother_model(dev, s, y, p, n_chains, n_burn, n_iter, seed, box=None):
    """The flagship smoother in the port, RW1 prior over ``s`` with a 1e-3 ridge;
    ``box`` truncates b's prior and starts b at y clipped just inside it."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import gmrf, structured as st
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    bands = gmrf.precision_irregular(s).bands.clone()
    bands[0, 0] += 1e-3
    trunc = {} if box is None else dict(domain_response_lower=np.full(p, box[0]),
                                        domain_response_upper=np.full(p, box[1]))
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P_lambda", "lambda"), **trunc),
        Gamma("lambda", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    b0 = y.copy() if box is None else np.clip(y, box[0] + 1e-3, box[1] - 1e-3)
    state = {"y": y, "b": b0, "mu": np.zeros(p), "lambda": 100.0, "P_lambda": st.Banded(bands), "a_lam": 10.0,
             "b_lam": 1.0, "tau": 1.0, "P_tau": st.Diagonal(torch.ones(p)), "a_tau": 1.0, "b_tau": 1.0}
    samplers = [NormalNormal("b", mdl), NormalGamma("lambda", mdl), NormalGamma("tau", mdl)]
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed,
                store_names=["b", "tau", "lambda"], device=dev)


def build_mcmc(dev, n_chains=None):
    """bench.py's model in the port: RW1 prior over 60 s with a 1e-3 ridge."""
    s = np.linspace(0.0, 60.0, N_TIME)
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + np.random.default_rng(0).normal(0.0, 1.0, N_TIME)
    return smoother_model(dev, s, y, N_TIME, n_chains or N_CHAINS, N_BURN, N_ITER, SEED)


KERNELS = ("spectral_smoother", "prng_draws", "tridiag_canonical", "gmrf_smoother", "truncnorm_draws", "linreg",
           "spectral_linreg", "random_walk", "mmala", "spectral_mmala", "mixture", "gamma_elem_draws", "rj", "gamma",
           "spectral_store")  # each wrapper's launch.<name> counter in the tracer
_launch_base = {}


def _launch_totals():
    from openmcmc_tpu_torch.utils import profiling

    totals = profiling.counters()
    return {name: totals.get(f"launch.{name}", 0) for name in KERNELS}


def reset_launches():
    """Count every kernel's launches from 0 again (from the totals now)."""
    _launch_base.clear()
    _launch_base.update(_launch_totals())


def read_launches():
    return {name: n - _launch_base.get(name, 0) for name, n in _launch_totals().items()}


def only(name, count, **others):
    """The launch counts of a path that launches kernel ``name`` ``count`` times,
    each of ``others`` its given count, and no other."""
    return {k: (count if k == name else others.get(k, 0)) for k in KERNELS}


def check_store(res, path):
    b = res.store["b"]
    if tuple(b.shape) != (N_CHAINS, N_ITER, N_TIME, 1) or b.device.type != DEVICE_TYPE:
        raise AssertionError(f"{path}: store b {tuple(b.shape)} on {b.device}")
    for name in ("tau", "lambda"):
        if tuple(res.store[name].shape) != (N_CHAINS, N_ITER, 1, 1):
            raise AssertionError(f"{path}: store {name} {tuple(res.store[name].shape)}")
    if tuple(res.log_post.shape) != (N_CHAINS, N_ITER):
        raise AssertionError(f"{path}: log_post {tuple(res.log_post.shape)}")
    for name, v in (*res.store.items(), ("log_post", res.log_post)):
        if not bool(torch.all(torch.isfinite(v))):
            raise AssertionError(f"{path}: non-finite values in {name}")
    tau_mean = float(res.store["tau"].mean())
    if not 0.5 <= tau_mean <= 2.0:
        raise AssertionError(f"{path}: tau posterior mean {tau_mean} outside [0.5, 2.0]")
    return tau_mean


def moments(draws, chunk_size=8):
    """Per coordinate of each (chains, n_iter, dims) tensor: posterior mean, sd
    and multi-chain ESS."""
    from openmcmc_tpu_torch.diagnostics import ess_per_param

    out = {}
    for name, d in draws.items():
        mean = torch.mean(d, dim=(0, 1), dtype=torch.float64)
        sd = torch.sqrt(torch.clamp(torch.mean(d * d, dim=(0, 1), dtype=torch.float64) - mean * mean, min=0.0))
        out[name] = (mean, sd, ess_per_param(d, chunk_size=chunk_size).double())
    return out


def posterior_moments(res, chunk_size=8):
    """Per coordinate of b, lambda and tau: posterior mean, sd and multi-chain ESS."""
    return moments({name: res.store[name][..., 0] for name in ("b", "lambda", "tau")}, chunk_size)


def moments_z(moments, reference):
    """The largest |mean difference| over its Monte Carlo sd, over b, lambda and tau."""
    worst = 0.0
    for name, (m1, s1, e1) in moments.items():
        m2, s2, e2 = reference[name]
        z = torch.abs(m1 - m2) / torch.sqrt(s1 * s1 / e1 + s2 * s2 / e2)
        worst = max(worst, float(z.max()))
    return worst


def main_plain(dev):
    """The main path's model, and the plain version's run at its width fed what
    the dispatcher should feed the kernel. It launches no kernel of the port, so
    it runs while nvcc builds them."""
    from openmcmc_tpu_torch.fused import spectral
    from openmcmc_tpu_torch.linalg import structured as st

    mcmc = build_mcmc(dev)
    plam = mcmc.data["P_lambda"]
    args, kw = kernel_inputs(
        dev, mcmc.data["y"].cpu().numpy()[:, 0], st.to_dense(plam).cpu().numpy(), N_CHAINS,
        noise=mcmc.data["P_tau"].diag_.cpu().numpy(), mu0=mcmc.data["mu"].cpu().numpy()[:, 0],
        logdet_p0=float(st.chol_log_det(st.cholesky(plam))),
    )
    hyp = dict(a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=N_BURN, n_keep=N_ITER, n_thin=1)
    want, plain_ms = cuda_call_ms(lambda: spectral.smoother_sweeps_plain(SEED, *args, **kw, **hyp))
    log("main", f"plain version of the main path's run: {plain_ms:.1f} ms (beside the build)")
    return mcmc, args, kw, hyp, want, plain_ms


def main_path_phase(mcmc, want):
    """MCMC.run(engine="auto") with the counts at 0 around it, one K1 launch and
    one store-kernel launch (counter ``spectral_smoother.store_kernel`` up by
    one), its store against the plain version's run, its posterior moments."""
    from openmcmc_tpu_torch.utils import profiling

    reset_launches()
    routed = profiling.counters().get("spectral_smoother.store_kernel", 0)
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    routed = profiling.counters().get("spectral_smoother.store_kernel", 0) - routed
    if res.engine != "fused_smoother_spectral":
        raise AssertionError(f"main path dispatched to {res.engine}")
    if launches != only("spectral_smoother", 1, spectral_store=1) or routed != 1:
        raise AssertionError(f"fused path: kernel launches {launches}, {routed} store-kernel routes, not one "
                             "spectral_smoother and one spectral_store launch")
    tau_mean = check_store(res, "fused path")
    b = res.store["b"]
    log("main", f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, "
        f"b {tuple(b.shape)}, first run {wall:.3f} s (build already done)")
    got = {"b": b[..., 0], "lam": res.store["lambda"][:, :, 0, 0], "tau": res.store["tau"][:, :, 0, 0],
           "log_post": res.log_post}
    agree, err = compare(got, want)
    if agree < 0.999 * N_CHAINS:
        raise AssertionError(f"only {agree} of {N_CHAINS} chains agree with the plain version")
    log("main", f"{agree} of {N_CHAINS} chains agree with the plain version (rtol 1e-4); max abs err {err:.3g}")

    moments = posterior_moments(res)
    ess_b = float(moments["b"][2].mean())
    log("main", f"tau posterior mean {tau_mean:.4f}; mean ESS of b {ess_b:.1f} over {N_CHAINS * N_ITER} draws")
    del res, got, b
    return launches, err, ess_b, moments


def timing_phase(mcmc, args, kw, hyp, ess_b, plain_ms, smi):
    """K1's time (the wrapper's call; its sweep kernel and its store kernel
    apart, by CUDA events and by the profiler), the bounds and MCMC.run end to
    end; ``plain_ms`` is the main path's check call of the plain version."""
    from torch.profiler import ProfilerActivity, profile

    from openmcmc_tpu_torch.fused import spectral

    def kernel():
        return spectral.smoother_sweeps_kernel(SEED, *args, **kw, **hyp)

    ms, sweep_ms, store_ms = split_ms(kernel, 5)
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kernel()
        torch.cuda.synchronize()
    prof_ms = {name: device_times_us(prof, f"{name}_kernel")[1] / 1e3 / reps
               for name in ("spectral_smoother", "spectral_store")}
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = mcmc.run(engine="auto")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    e2e = statistics.median(walls)
    # bytes: V, the eigenvalues and projections, lam0/tau0 in; b, lam, tau, log_post out
    p, n_keep, n_sweeps = N_TIME, hyp["n_keep"], hyp["n_burn"] + hyp["n_keep"] * hyp["n_thin"]
    n_bytes = 4 * (p * p + 3 * p + 2 * N_CHAINS + N_CHAINS * n_keep * (p + 3))
    n_flop = N_CHAINS * (n_sweeps * (K1_FLOP_PER_COORD * p + K1_FLOP_PER_SWEEP)
                         + n_keep * (2 * p * p + K1_FLOP_PER_STORE))
    bound_ms, bound_by = bound(n_bytes, n_flop)
    rows = N_CHAINS * n_keep
    store_flop = 2.0 * rows * p * p
    store_bound_ms, store_bound_by = bound(4.0 * (2 * rows * p + p * p), store_flop)
    log("time", f"{smi}: spectral kernel {ms:.3f} ms (median of 5): sweep kernel {sweep_ms:.4f} ms, "
        f"store kernel {store_ms:.4f} ms ({store_flop / store_ms / 1e9:.1f} TFLOP/s, bound "
        f"{store_bound_ms:.4f} ms, {store_bound_by}) by CUDA events; by the profiler "
        f"{prof_ms['spectral_smoother']:.4f} and {prof_ms['spectral_store']:.4f} ms a call (mean of {reps}); "
        f"plain {plain_ms:.1f} ms (the check's call), bound {bound_ms:.3f} ms ({bound_by}: {n_flop:.3g} "
        f"FLOP, {n_bytes:.3g} B), MCMC.run end to end {1e3 * e2e:.3f} ms (median of 5)")
    log("time", f"{smi}: ESS/s {ess_b / (ms / 1e3):.4g} on kernel time, {ess_b / e2e:.4g} end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "run_sweep_ms": sweep_ms, "run_store_ms": store_ms, "store_bound_ms": store_bound_ms,
            "run_sweep_profiler_ms": prof_ms["spectral_smoother"],
            "run_store_profiler_ms": prof_ms["spectral_store"]}


def tridiag_inputs(dev, n_chains, p, seed):
    """Per-chain diagonally dominant tridiagonal Q = (a, c) and b on the card."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n_chains, p))
    c[:, -1] = 0.0
    a = 2.5 + rng.uniform(0.0, 3.0, (n_chains, p))
    b = rng.normal(size=(n_chains, p))
    return [torch.as_tensor(t, dtype=torch.float32, device=dev) for t in (a, c, b)]


def tridiag_phase(dev, smi):
    """K3 against its plain version on the same Philox bits, value for value, at
    the main path's shape, at thomas_long's twin's and at a ragged one, and on a
    forced IEEE rerun bit for bit; its draw's moments; then the kernel alone
    (one launch on prepared arguments) and the wrapper, timed at both paths'
    shapes."""
    from openmcmc_tpu_torch.linalg import tridiag

    worst, equal = 0.0, {}
    for n_chains, p in ((N_CHAINS, N_TIME), (1000, 4099), (L_CHAINS, L_P)):
        a, c, b = tridiag_inputs(dev, n_chains, p, seed=p)
        got = tridiag.sample_canonical_tridiag(SEED, 123, a, c, b)
        want = tridiag.sample_canonical_tridiag_plain(SEED, 123, a, c, b)
        torch.cuda.synchronize()
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
        if tuple(got.shape) != tuple(a.shape) or not bool(close.all()):
            raise AssertionError(f"tridiag kernel at ({n_chains}, {p}): {int((~close).sum())} values differ "
                                 "from the plain version (rtol 1e-4, atol 1e-5)")
        err = float(torch.max(torch.abs(got - want)))
        worst = max(worst, err)
        equal[f"{n_chains}x{p}"] = int((got == want).sum())
        log("tridiag", f"({n_chains}, {p}): all values agree with the plain version (rtol 1e-4, atol 1e-5), "
            f"{equal[f'{n_chains}x{p}']} of {got.numel()} equal bit for bit, max abs err {err:.3g}")
        del a, c, b, got, want, close

    # b at 1e-16 puts |ld w| below the certified range: every block reruns with the IEEE operators
    a, c, b = tridiag_inputs(dev, 1000, 300, seed=300)
    got = tridiag.sample_canonical_tridiag(SEED, 124, a, c, b * 1e-16)
    want = tridiag.sample_canonical_tridiag_plain(SEED, 124, a, c, b * 1e-16)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"tridiag kernel's IEEE rerun: {int((got != want).sum())} of {got.numel()} values "
                             "differ from the plain version")
    log("tridiag", "forced IEEE rerun (b at 1e-16, 1000 chains, p = 300): every value equal to the plain version "
        "bit for bit")

    # one Q and b shared by every chain: the flagship's conditional at lambda = 100, tau = 1
    s, P = rw1_p0(N_TIME, 1e-3)
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + np.random.default_rng(0).normal(0.0, 1.0, N_TIME)
    bands = 100.0 * P.bands.double().numpy()
    bands[0] += 1.0
    Q = np.diag(bands[0]) + np.diag(bands[1, :-1], 1) + np.diag(bands[1, :-1], -1)
    cov = np.linalg.inv(Q)
    a, c, b = (torch.as_tensor(np.broadcast_to(v, (N_CHAINS, N_TIME)).copy(), dtype=torch.float32, device=dev)
               for v in (bands[0], bands[1], y))
    x = tridiag.sample_canonical_tridiag(SEED, 5, a, c, b).double()
    sd = np.sqrt(np.diag(cov))
    z = np.abs(x.mean(0).cpu().numpy() - cov @ y) / (sd / np.sqrt(N_CHAINS))
    if not np.all(z < 5.0):
        raise AssertionError(f"tridiag kernel: chain mean of x off Q^-1 b by {z.max():.2f} sd/sqrt(B)")
    log("tridiag", f"chain mean of x within {z.max():.2f} sd/sqrt(B) of Q^-1 b over {N_CHAINS} chains")

    def times(a, c, b, reps, plain_reps):
        """The kernel: launches back to back on prepared arguments between two
        events, over their count (median of 5 batches), so the host's launch
        time hides behind the card's; the wrapper: one call between two events
        (median of ``reps``), its host time included, as the generic sweep
        meets it."""
        args = tridiag.launch_args(SEED, 5, a, c, b)
        tridiag.launch(*args)
        torch.cuda.synchronize()
        kernel_ms = statistics.median(
            cuda_call_ms(lambda: [tridiag.launch(*args) for _ in range(reps)])[1] / reps for _ in range(5))
        wrapper_ms = cuda_ms(lambda: tridiag.sample_canonical_tridiag(SEED, 5, a, c, b), reps)
        plain_ms = cuda_ms(lambda: tridiag.sample_canonical_tridiag_plain(SEED, 5, a, c, b), plain_reps)
        n = a.numel()
        return (kernel_ms, wrapper_ms, plain_ms, *bound(16 * n, K3_FLOP_PER_ELEM * n))

    ms, wrapper_ms, plain_ms, bound_ms, bound_by = times(a, c, b, 25, 5)
    log("tridiag", f"{smi}: at ({N_CHAINS}, {N_TIME}) the kernel takes {ms:.4f} ms (25 launches back to back, "
        f"median of 5), the wrapper {wrapper_ms:.4f} ms a call (median of 25), plain {plain_ms:.3f} ms (median of "
        f"5), bound {1e3 * bound_ms:.2f} us ({bound_by})")
    a, c, b = tridiag_inputs(dev, L_CHAINS, L_P, seed=L_P)
    long_ms, long_wrapper_ms, long_plain_ms, long_bound_ms, long_bound_by = times(a, c, b, 10, 1)
    log("tridiag", f"{smi}: at ({L_CHAINS}, {L_P}) the kernel takes {long_ms:.4f} ms (10 launches back to back, "
        f"median of 5), the wrapper {long_wrapper_ms:.4f} ms a call (median of 10), plain {long_plain_ms:.1f} ms "
        f"(one call), bound {long_bound_ms:.4f} ms ({long_bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "wrapper_ms": wrapper_ms, "bit_equal": equal,
            "thomas_long_twin": {"ms": long_ms, "wrapper_ms": long_wrapper_ms, "plain_ms": long_plain_ms,
                                 "bound_ms": long_bound_ms, "bound_by": long_bound_by}}


def sync_count(dev, n_burn, n_iter):
    """Synchronising CUDA operations torch reports during a small generic run."""
    mcmc = build_mcmc(dev, n_chains=256)
    mcmc.n_burn, mcmc.n_iter = n_burn, n_iter
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mcmc.run(engine="generic")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_times_us(prof, kernel="tridiag_canonical"):
    """Device busy time, the named kernel's device time (microseconds) and the
    five entries with the most device time, from the key averages of a
    device-only trace (kernels, copies and fills, so no time is counted twice)."""
    def self_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)

    events = [e for e in prof.key_averages() if self_us(e) > 0]
    top = sorted(events, key=self_us, reverse=True)[:5]
    return (sum(self_us(e) for e in events), sum(self_us(e) for e in events if kernel in e.key),
            [(e.key[:60], e.count, round(self_us(e) / 1e3, 3)) for e in top])


def generic_phase(dev, fused_moments, k3, smi):
    """No per-sweep synchronisation in the generic driver; then the driver at full
    width, its K3 launches, its posterior against the fused run's, and its time."""
    from torch.profiler import ProfilerActivity, profile

    sync_count(dev, 1, 1)  # first-call work (library loads, generator set-up) out of the count and the timing
    few, more = sync_count(dev, 2, 3), sync_count(dev, 6, 9)
    if more > few:
        raise AssertionError(f"generic path synchronises per sweep: {few} syncs in 5 sweeps, {more} in 15")
    log("generic", f"synchronising operations per run: {few} at 5 sweeps, {more} at 15 (none per sweep)")

    mcmc = build_mcmc(dev)
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="generic")
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = read_launches()
    n_sweeps = N_BURN + N_ITER * mcmc.n_thin
    if res.engine != "generic":
        raise AssertionError(f"generic path ran {res.engine}")
    if launches != only("tridiag_canonical", n_sweeps):
        raise AssertionError(f"generic path: kernel launches {launches}, not {n_sweeps} tridiag_canonical launches")
    tau_mean = check_store(res, "generic path")
    from openmcmc_tpu_torch.diagnostics import summary

    scales = {name: summary(res.store[name][:, :, 0, 0]) for name in ("lambda", "tau")}
    for name, summ in scales.items():
        if not float(summ["rhat"]) < 1.05:
            raise AssertionError(f"generic path: split-R-hat of {name} {float(summ['rhat']):.4f} is not below 1.05")
    moments = posterior_moments(res)
    ess_b = float(moments["b"][2].mean())
    del res
    worst = moments_z(moments, fused_moments)
    if not worst < 5.0:
        raise AssertionError(f"generic path: a posterior mean of b, lambda or tau is off the fused run's by "
                             f"{worst:.2f} MC sd")
    log("generic", f"MCMC.run(engine='generic'): kernel launches {launches}; tau posterior mean {tau_mean:.4f}; "
        f"means of b, lambda, tau within {worst:.2f} MC sd of the fused run's (limit 5)")
    log("generic", "summary: " + "; ".join(
        f"{name} mean {float(v['mean']):.4f} sd {float(v['sd']):.4f} q05-q95 [{float(v['q05']):.4f}, "
        f"{float(v['q95']):.4f}] ESS {float(v['ess']):.1f} R-hat {float(v['rhat']):.5f}" for name, v in scales.items()))
    log("generic", f"{smi}: MCMC.run(engine='generic') {1e3 * e2e:.3f} ms (warm: after the synchronisation "
        f"runs); K3 {n_sweeps} x {k3['ms']:.4f} ms = {n_sweeps * k3['ms']:.3f} ms of kernel "
        f"({100 * n_sweeps * k3['ms'] / (1e3 * e2e):.1f} % of the run), {n_sweeps} x {k3['wrapper_ms']:.4f} ms = "
        f"{n_sweeps * k3['wrapper_ms']:.3f} ms through the wrapper "
        f"({100 * n_sweeps * k3['wrapper_ms'] / (1e3 * e2e):.1f} %); mean ESS of b {ess_b:.1f}; "
        f"ESS/s {ess_b / e2e:.4g} end to end")

    # a short steady window under a device-only trace: 5 burn-in and 15 stored sweeps at full width
    mcmc.n_burn, mcmc.n_iter = 5, 15
    n_window = mcmc.n_burn + mcmc.n_iter
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mcmc.run(engine="generic")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy_us, k3_us, top = device_times_us(prof)
    if busy_us > 0:
        share = (f"profiled window of {n_window} sweeps: wall {1e3 * prof_wall:.3f} ms under the profiler, device "
                 f"busy {busy_us / 1e3:.3f} ms, K3 {k3_us / 1e3:.3f} ms ({k3_us / n_window:.2f} us per launch, "
                 f"{100 * k3_us / busy_us:.1f} % of device time), device idle {100 * (1 - 1e-3 * busy_us / (1e3 * prof_wall)):.1f} %")
    else:
        share = "profiler reported no device time: idle share not measured"
    log("generic", f"{smi}: {share}")
    log("generic", f"most device time in the window (name, calls, ms): {top}")
    return launches


def truncnorm_phase(dev):
    """truncnorm_draws (erf_poly and truncnorm_draw, the device functions K4's
    truncated sweep inlines) against its plain version, over the truncated
    cell's draw counters: the box [0, 3.5], every seventh row open (+-1e30)."""
    from openmcmc_tpu_torch.fused import prng

    groups = (N_TIME + 3) // 4
    chain = torch.arange(T_CHAINS, dtype=torch.int64).repeat_interleave(groups)
    group = torch.arange(groups, dtype=torch.int64).repeat(T_CHAINS)
    ctr = torch.stack([chain, torch.full_like(chain, 3), torch.zeros_like(chain), group], 1).to(torch.int32)
    n = ctr.shape[0]
    gen = torch.Generator().manual_seed(2)
    x = 3.0 * torch.randn((n, 4), generator=gen)
    mu = 2.0 + 1.5 * torch.randn((n, 4), generator=gen)
    scale = 0.05 + 0.3 * torch.rand((n, 4), generator=gen)
    lo, hi = torch.full((n, 4), T_BOX[0]), torch.full((n, 4), T_BOX[1])
    lo[::7], hi[::7], x[::7] = -1e30, 1e30, 1e30
    args = [t.to(dev).contiguous() for t in (ctr, x, mu, scale, lo, hi)]
    got = prng.truncnorm_draws(SEED, *args)
    want = prng.truncnorm_draws_plain(SEED, *args)
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in (("erf_poly", got[0], want[0]), ("truncnorm_draw", got[1], want[1])):
        rel = float(torch.max(torch.abs(g - w) / torch.clamp(torch.abs(w), min=1.0)))
        if not bool(torch.all(torch.isfinite(g))) or rel > 1e-6:
            raise AssertionError(f"truncnorm_draws: {name} differs from the plain version by {rel:.3g} (relative)")
        worst = max(worst, float(torch.max(torch.abs(g - w))))
    if not bool(torch.all((got[1] >= args[4]) & (got[1] <= args[5]))):
        raise AssertionError("truncnorm_draws: a draw left its box")
    ms = cuda_ms(lambda: prng.truncnorm_draws(SEED, *args), 5)
    plain_ms = cuda_ms(lambda: prng.truncnorm_draws_plain(SEED, *args), 3)
    bound_ms, bound_by = bound(n * 128, n * K2T_FLOP_PER_ROW)
    log("truncnorm", f"{n} rows: erf_poly and truncated draws within 1e-6 rel of the plain version, every draw in "
        f"its box; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def k4_args(dev, y, bands, noise, mu0, n_chains, box=None, b_init=None):
    """K4's inputs as run_fused_smoother prepares them, with the cells' priors
    (Gamma(10, 1) on lambda, Gamma(1, 1) on tau, lambda0 = 100, tau0 = 1)."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    bounds = {} if box is None else dict(lower=box[0], upper=box[1], b_init=b_init)
    prep = gs.prepare(y, None, P0_bands=bands, noise_diag=noise, mu0=mu0, device=dev, **bounds)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [prep[k] for k in ("p0d", "p0c", "y", "d", "mu", "p0mu")]
    args += [torch.full((n_chains,), 100.0, **f32), torch.full((n_chains,), 1.0, **f32)]
    kw = dict(logdet_p0=prep["logdet_p0"], logdet_d=prep["logdet_d"], a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0)
    if box is not None:
        kw.update(lo=prep["lo"], hi=prep["hi"], b_init=prep["b_init"].expand(n_chains, -1).contiguous())
    return args, kw


def mcmc_k4_args(dev, mcmc):
    """k4_args for a built smoother MCMC, fed what the dispatcher feeds the kernel."""
    b_dist = mcmc.model["b"]
    box = None
    if b_dist.truncated:
        box = (np.asarray(b_dist.domain_response_lower), np.asarray(b_dist.domain_response_upper))
    return k4_args(dev, mcmc.data["y"][:, 0], mcmc.data["P_lambda"].bands, mcmc.data["P_tau"].diag_,
                   mcmc.data["mu"][:, 0], mcmc.n_chains, box, mcmc.initial_chain_state["b"].reshape(-1))


def gmrf_small_phase(dev):
    """K4 against its plain version on the same Philox bits, every value, both
    variants, at (256 chains, p = 100) and at a ragged (1000, 1031); n_burn 3,
    n_keep 5, n_thin 2."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    worst = 0.0
    for truncated in (False, True):
        for chains, p in ((256, N_TIME), (1000, 1031)):
            rng = np.random.default_rng(p)
            s, P0 = rw1_p0(p, 1e-3)
            y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + rng.normal(0.0, 1.0, p)
            box = T_BOX if truncated else None
            args, kw = k4_args(dev, y, P0.bands, rng.uniform(0.5, 2.0, p), 0.1 * rng.normal(size=p), chains, box,
                               np.clip(y, 1e-3, 3.5 - 1e-3))
            hyp = dict(n_burn=3, n_keep=5, n_thin=2)
            got = gs.gmrf_smoother_kernel(11, *args, **kw, **hyp)
            want = gs.gmrf_smoother_plain(11, *args, **kw, **hyp)
            torch.cuda.synchronize()
            agree, err = compare(got, want)
            same = equal_chains(got, want, ("b", "lam", "tau", "log_post"))
            name = f"{'truncated' if truncated else 'thomas'} ({chains}, {p})"
            if agree != chains:
                raise AssertionError(f"gmrf_smoother kernel, {name}: {chains - agree} of {chains} chains differ")
            if truncated and not bool(torch.all((got["b"] >= kw["lo"]) & (got["b"] <= kw["hi"]))):
                raise AssertionError(f"gmrf_smoother kernel, {name}: a draw left the box")
            worst = max(worst, err)
            log("gmrf", f"{name}, n_burn=3 n_iter=5 n_thin=2: all values agree with the plain version "
                f"(rtol 1e-4), {same} of {chains} chains bit for bit, max abs err {err:.3g}")
    return worst


def truncated_mcmc(dev):
    """bench_all.py's truncated_smoother at 4096 chains: its data (numpy seed 0),
    box, priors and depth; precision_temporal over its one-minute date range is
    the RW1 precision of linspace(0, 60, 100)."""
    s = np.linspace(0.0, 60.0, N_TIME)
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + np.random.RandomState(0).normal(0.0, 1.0, N_TIME)
    return smoother_model(dev, s, y, N_TIME, T_CHAINS, T_BURN, T_ITER, T_SEED, box=T_BOX)


def long_mcmc(dev, n_burn=L_BURN, n_iter=L_ITER):
    """The flagship model at p = 4096 (0.6 s spacing), past the spectral engine's
    tridiagonal limit."""
    s = 0.6 * np.arange(L_P)
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + np.random.RandomState(1).normal(0.0, 1.0, L_P)
    return smoother_model(dev, s, y, L_P, L_CHAINS, n_burn, n_iter, SEED)


def k4_cell(dev, tag, mcmc, engine, box):
    """One K4 cell's run: MCMC.run(engine="auto") with the counts at 0 around it,
    one K4 launch and no other, the store's shape, finiteness and box. Returns
    the result, the counts and K4's inputs for that run."""
    n_chains, n_iter, p = mcmc.n_chains, mcmc.n_iter, mcmc.data["y"].shape[0]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only("gmrf_smoother", 1):
        raise AssertionError(f"{tag}: engine {res.engine}, kernel launches {launches}")
    b = res.store["b"]
    if tuple(b.shape) != (n_chains, n_iter, p, 1) or tuple(res.log_post.shape) != (n_chains, n_iter):
        raise AssertionError(f"{tag}: store b {tuple(b.shape)}, log_post {tuple(res.log_post.shape)}")
    for name, v in (*res.store.items(), ("log_post", res.log_post)):
        if not bool(torch.all(torch.isfinite(v))):
            raise AssertionError(f"{tag}: non-finite values in {name}")
    if box is not None and not (float(b.min()) >= box[0] and float(b.max()) <= box[1]):
        raise AssertionError(f"{tag}: draws outside [{box[0]}, {box[1]}]")
    log(tag, f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, b {tuple(b.shape)}, "
        f"first run {wall:.3f} s; tau posterior mean {float(res.store['tau'].mean()):.4f}")
    args, kw = mcmc_k4_args(dev, mcmc)
    hyp = dict(n_burn=mcmc.n_burn, n_keep=n_iter, n_thin=1)
    return res, launches, args, kw, hyp


def k4_times(smi, tag, mcmc, args, kw, hyp, flop_per_row, ess_b, plain_ms, reps, plain_hyp=None):
    """K4's time (CUDA events) and MCMC.run end to end, each the median of
    ``reps`` runs, and the bound. ``plain_ms``
    is the cell's check call of the plain version, on the whole run or, where
    that is too slow, on the shorter run ``plain_hyp`` of the same width, on
    which the kernel is then timed too."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    n_chains, p = args[-1].shape[0], args[0].shape[0]

    def kernel(h=hyp):
        return gs.gmrf_smoother_kernel(mcmc.seed, *args, **kw, **h)

    full_ms = cuda_ms(kernel, reps)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = mcmc.run(engine="auto")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    e2e = statistics.median(walls)
    timed = plain_hyp or hyp
    ms = full_ms if plain_hyp is None else cuda_ms(lambda: kernel(h=plain_hyp), 3)

    def k4_bound(h):
        n_sweeps, n_keep = h["n_burn"] + h["n_keep"] * h["n_thin"], h["n_keep"]
        n_in = 6 * p + 2 * n_chains + (2 * p + n_chains * p if "lo" in kw else 0)
        n_bytes = 4 * (n_in + n_chains * n_keep * (p + 3))
        n_flop = n_chains * (n_sweeps * (flop_per_row * p + K4_FLOP_PER_SWEEP) + n_keep * K4_FLOP_PER_STORE)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    full_bound = k4_bound(hyp)
    bound_ms, bound_by, n_flop, n_bytes = k4_bound(timed)
    where = "" if plain_hyp is None else f" at n_burn {timed['n_burn']}, n_iter {timed['n_keep']}"
    n_sweeps = hyp["n_burn"] + hyp["n_keep"] * hyp["n_thin"]
    log(tag, f"{smi}: gmrf_smoother kernel {full_ms:.3f} ms for the whole run (median of {reps}), "
        f"{1e3 * full_ms / n_sweeps:.2f} us a sweep over {n_sweeps} sweeps, bound {full_bound[0]:.4f} ms "
        f"({full_bound[1]}: {full_bound[2]:.3g} FLOP, {full_bound[3]:.3g} B); MCMC.run end to end "
        f"{1e3 * e2e:.3f} ms (median of {reps})")
    log(tag, f"{smi}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms (the check's call), bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B){where}")
    log(tag, f"{smi}: ESS/s of b {ess_b / (full_ms / 1e3):.4g} on kernel time, {ess_b / e2e:.4g} end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def truncated_phase(dev, smi):
    """The truncated cell: one K4 launch, every chain against the plain version at
    full width (>= 99.9 % agree), posterior means against the generic driver's
    red-black run, times."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    tag = "truncated"
    mcmc = truncated_mcmc(dev)
    res, launches, args, kw, hyp = k4_cell(dev, tag, mcmc, "fused_gmrf_smoother_truncated", T_BOX)
    want, plain_ms = cuda_call_ms(lambda: gs.gmrf_smoother_plain(T_SEED, *args, **kw, **hyp))
    got = {"b": res.store["b"][..., 0], "lam": res.store["lambda"][:, :, 0, 0], "tau": res.store["tau"][:, :, 0, 0],
           "log_post": res.log_post}
    agree, err = compare(got, want)
    same = equal_chains(got, want, ("b", "lam", "tau", "log_post"))
    del want, got
    if agree < 0.999 * T_CHAINS:
        raise AssertionError(f"{tag}: only {agree} of {T_CHAINS} chains agree with the plain version")
    moments = posterior_moments(res)
    ess_b = float(moments["b"][2].mean())
    del res
    t0 = time.perf_counter()
    gen = truncated_mcmc(dev).run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    if gen.engine != "generic" or not (float(gen.store["b"].min()) >= T_BOX[0]
                                       and float(gen.store["b"].max()) <= T_BOX[1]):
        raise AssertionError(f"{tag}: generic run {gen.engine} left the box or did not run")
    z = moments_z(moments, posterior_moments(gen))
    del gen
    if not z < 5.0:
        raise AssertionError(f"{tag}: posterior means off the generic run's by {z:.2f} MC sd")
    log(tag, f"{agree} of {T_CHAINS} chains agree with the plain version (rtol 1e-4), {same} bit for bit, max abs "
        f"err {err:.3g}; "
        f"means of b, lambda, tau within {z:.2f} MC sd of the generic run's (limit 5; generic run {gen_wall:.3f} s); "
        f"mean ESS of b {ess_b:.1f} over {T_CHAINS * T_ITER} draws")
    entry = k4_times(smi, tag, mcmc, args, kw, hyp, K4_FLOP_PER_TRUNC_ROW, ess_b, plain_ms, reps=3)
    return {"launches": launches["gmrf_smoother"], "max_abs_err": err, **entry}, launches


def thomas_long_phase(dev, smi, k3):
    """The long-series cell: one K4 launch, the kernel against the plain version
    on a short run at full width, posterior means against the generic (K3) run,
    times."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    tag = "thomas_long"
    mcmc = long_mcmc(dev)
    res, launches, args, kw, hyp = k4_cell(dev, tag, mcmc, "fused_gmrf_smoother", None)
    moments = posterior_moments(res, chunk_size=256)
    ess_b = float(moments["b"][2].mean())
    del res
    torch.cuda.empty_cache()
    short = dict(n_burn=2, n_keep=3, n_thin=1)
    got = gs.gmrf_smoother_kernel(SEED, *args, **kw, **short)
    want, plain_ms = cuda_call_ms(lambda: gs.gmrf_smoother_plain(SEED, *args, **kw, **short))
    agree, err = compare(got, want)
    same = equal_chains(got, want, ("b", "lam", "tau", "log_post"))
    del got, want
    if same != L_CHAINS:
        raise AssertionError(f"{tag}: {L_CHAINS - same} of {L_CHAINS} chains differ from the plain version bit for "
                             f"bit ({L_CHAINS - agree} beyond rtol 1e-4)")
    reset_launches()
    t0 = time.perf_counter()
    gen = long_mcmc(dev, L_GEN_BURN, L_GEN_ITER).run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches()
    if gen.engine != "generic" or gen_launches != only("tridiag_canonical", L_GEN_BURN + L_GEN_ITER):
        raise AssertionError(f"{tag}: generic run {gen.engine}, kernel launches {gen_launches}")
    z = moments_z(moments, posterior_moments(gen, chunk_size=256))
    del gen
    torch.cuda.empty_cache()
    if not z < 5.0:
        raise AssertionError(f"{tag}: posterior means off the generic run's by {z:.2f} MC sd")
    log(tag, f"kernel and plain version equal bit for bit on all {L_CHAINS} chains at p = {L_P}, n_burn 2, "
        f"n_iter 3 ({agree} within rtol 1e-4), max abs err {err:.3g}; means of b, lambda, tau within {z:.2f} MC sd of the generic (K3) run's "
        f"(limit 5; generic run of {L_GEN_BURN} + {L_GEN_ITER} sweeps {gen_wall:.3f} s); mean ESS of b {ess_b:.1f} over "
        f"{L_CHAINS * L_ITER} draws")
    n_gen = k3["launches"] = gen_launches["tridiag_canonical"]
    log(tag, f"{smi}: the generic (K3) run's {n_gen} K3 launches at ({L_CHAINS}, {L_P}): {n_gen} x {k3['ms']:.4f} ms "
        f"= {n_gen * k3['ms']:.3f} ms of kernel ({100 * n_gen * k3['ms'] / (1e3 * gen_wall):.1f} % of its "
        f"{gen_wall:.3f} s), {n_gen * k3['wrapper_ms']:.3f} ms through the wrapper")
    entry = k4_times(smi, tag, mcmc, args, kw, hyp, K4_FLOP_PER_THOMAS_ROW, ess_b, plain_ms, reps=3,
                     plain_hyp=short)
    return {"launches": launches["gmrf_smoother"], "max_abs_err": err, **entry}


def linreg_mcmc(dev, X, y, n_chains, n_burn, n_iter, seed, a, b):
    """Reference example 3's model in the port: y ~ N(X beta, (tau I)^-1),
    beta ~ N(0, (lambda I)^-1), Gamma(a, b) on tau and lambda, tau0 = 1,
    lambda0 = 0.01."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    N, p = X.shape
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P_tau", "tau")),
        Normal("beta", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("tau", shape="a_tau", rate="b_tau"),
        Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ])
    state = {"y": y, "X": X, "beta": np.zeros(p), "P_tau": st.Diagonal(torch.ones(N)), "tau": 1.0,
             "P_lambda": st.Diagonal(torch.ones(p)), "mu": np.zeros(p), "lambda": 0.01,
             "a_tau": a, "b_tau": b, "a_lambda": a, "b_lambda": b}
    samplers = [NormalNormal("beta", mdl), NormalGamma("tau", mdl), NormalGamma("lambda", mdl)]
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed, device=dev)


def example3_data():
    """bench_all.py's linreg data: x sorted uniform, X = [1, x], y = X [2, 0.5] + N(0, 0.1^2)."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.random(R_N))
    X = np.stack([np.ones(R_N), x], 1)
    return X, X @ np.array([2.0, 0.5]) + rng.normal(0.0, 0.1, R_N)


def wide_data():
    """X iid N(0, 1) (N = 2048, p = 256), beta_true ~ N(0, 1), y = X beta_true + N(0, 0.5^2)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(W_N, W_P))
    beta = rng.normal(size=W_P)
    return X, X @ beta + rng.normal(0.0, 0.5, W_N)


def linreg_moments(res, chunk_size):
    """Posterior mean, sd and ESS of each beta, tau and log lambda (lambda's
    posterior is heavy-tailed when its conditional shape is near 1)."""
    return moments({"beta": res.store["beta"][..., 0], "tau": res.store["tau"][..., 0],
                    "log_lambda": torch.log(res.store["lambda"][..., 0])}, chunk_size)


def linreg_cell(tag, mcmc, engine, kernel, **others):
    """One linear-regression cell's run: MCMC.run(engine="auto") with the counts
    at 0 around it, one launch of ``kernel``, ``others`` (the counts of any other
    kernel the path launches) and no other, the store's shape and finiteness."""
    n_chains, n_iter, p = mcmc.n_chains, mcmc.n_iter, mcmc.data["X"].shape[1]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only(kernel, 1, **others):
        raise AssertionError(f"{tag}: engine {res.engine}, kernel launches {launches}")
    shapes = {"beta": (n_chains, n_iter, p, 1), "tau": (n_chains, n_iter, 1, 1), "lambda": (n_chains, n_iter, 1, 1)}
    if {k: tuple(v.shape) for k, v in res.store.items()} != shapes or tuple(res.log_post.shape) != (n_chains, n_iter):
        raise AssertionError(f"{tag}: store {[tuple(v.shape) for v in res.store.values()]}")
    for name, v in (*res.store.items(), ("log_post", res.log_post)):
        if not bool(torch.all(torch.isfinite(v))) or v.device.type != DEVICE_TYPE:
            raise AssertionError(f"{tag}: non-finite values in {name}, or not on the card")
    log(tag, f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, beta "
        f"{tuple(res.store['beta'].shape)}, first run {wall:.3f} s; tau posterior mean "
        f"{float(res.store['tau'].mean()):.4f}")
    return res, launches


def linreg_checks(tag, mcmc, res, kernel_fn, plain_fn, args, kw, short, gen_mcmc, chunk_size, exact=False):
    """The kernel against its plain version on a short run at full width
    (>= 99.9 % of chains agree; with ``exact`` every chain's lam, tau and
    log_post bit for bit), the count of beta values that differ from the plain
    version's, and the fused run's posterior means of beta, tau and log lambda
    against the generic twin's (within 5 MC sd), which launches no kernel (the
    dense NormalNormal step)."""
    fused = linreg_moments(res, chunk_size)
    ess_beta = float(fused["beta"][2].mean())
    del res
    torch.cuda.empty_cache()
    got = kernel_fn(mcmc.seed, *args, **kw, **short)
    want, plain_ms = cuda_call_ms(lambda: plain_fn(mcmc.seed, *args, **kw, **short))
    agree, err = compare(got, want, draw="beta")
    same = equal_chains(got, want, ("lam", "tau", "log_post"))
    beta_diff = int((got["beta"] != want["beta"]).sum())
    del got, want
    n_chains = mcmc.n_chains
    if agree < 0.999 * n_chains:
        raise AssertionError(f"{tag}: only {agree} of {n_chains} chains agree with the plain version")
    if exact and same != n_chains:
        raise AssertionError(f"{tag}: lam, tau and log_post of only {same} of {n_chains} chains equal the plain "
                             "version's bit for bit")
    reset_launches()
    t0 = time.perf_counter()
    gen = gen_mcmc.run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches()
    if gen.engine != "generic" or any(gen_launches.values()):
        raise AssertionError(f"{tag}: the generic twin ran {gen.engine} with kernel launches {gen_launches}")
    z = moments_z(fused, linreg_moments(gen, chunk_size))
    del gen
    torch.cuda.empty_cache()
    if not z < 5.0:
        raise AssertionError(f"{tag}: posterior means off the generic run's by {z:.2f} MC sd")
    log(tag, f"kernel and plain version agree on {agree} of {n_chains} chains at n_burn {short['n_burn']}, n_iter "
        f"{short['n_keep']} (rtol 1e-4; lam, tau and log_post of {same} bit for bit), max abs err {err:.3g}, "
        f"{beta_diff} beta values differ; means of beta, tau, log lambda within {z:.2f} MC sd "
        f"of the generic run's (limit 5; generic run of {gen_mcmc.n_chains} chains, {gen_mcmc.n_burn} + "
        f"{gen_mcmc.n_iter} sweeps, {gen_wall:.3f} s); mean ESS of beta {ess_beta:.1f} over "
        f"{n_chains * mcmc.n_iter} draws")
    return err, plain_ms, ess_beta, {"bit_identical_chains": same, "beta_values_differing": beta_diff}


def split_ms(call, reps):
    """Medians of ``reps`` calls of a spectral sweep wrapper (K1, K5 or K9): the whole
    call, its sweep kernel (from the call's start to the store's) and its store
    kernel (the store wrapper's launches), all by CUDA events on one stream."""
    from openmcmc_tpu_torch.fused import spectral

    whole, sweep, store = [], [], []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with launch_events(spectral, "spectral_store_kernel") as marks:
            start.record()
            out = call()
            stop.record()
            torch.cuda.synchronize()
        if len(marks) != 1:
            raise AssertionError(f"a spectral sweep wrapper called the store {len(marks)} times")
        whole.append(start.elapsed_time(stop))
        sweep.append(start.elapsed_time(marks[0][0]))
        store.append(marks[0][0].elapsed_time(marks[0][1]))
        del out
    return tuple(statistics.median(v) for v in (whole, sweep, store))


def run_times(kernel_fn, seed, args, kw, run_hyp, short, reps, split):
    """The kernel's time on the whole run (with ``split``, also its sweep and
    store kernels'), on the same sweeps with one stored draw, and on the plain
    version's short run, by CUDA events, medians of ``reps``."""
    n_sweeps = run_hyp["n_burn"] + run_hyp["n_keep"] * run_hyp["n_thin"]
    if split:
        run_ms, sweep_ms, store_ms = split_ms(lambda: kernel_fn(seed, *args, **kw, **run_hyp), reps)
        parts = {"run_sweep_ms": sweep_ms, "run_store_ms": store_ms}
    else:
        run_ms, parts = cuda_ms(lambda: kernel_fn(seed, *args, **kw, **run_hyp), reps), {}
    # the same sweeps with one stored draw: the rest of run_ms is the stores' share
    sweeps_ms = cuda_ms(lambda: kernel_fn(seed, *args, **kw, n_burn=n_sweeps - 1, n_keep=1, n_thin=1), reps)
    ms = cuda_ms(lambda: kernel_fn(seed, *args, **kw, **short), reps)
    return run_ms, parts, sweeps_ms, ms


def split_text(parts):
    return (f" (sweep kernel {parts['run_sweep_ms']:.4f} ms, store kernel {parts['run_store_ms']:.4f} ms)"
            if parts else "")


def linreg_times(smi, tag, mcmc, kernel_fn, args, kw, run_hyp, short, flop_fn, n_in, ess_beta, plain_ms, reps,
                 split=False):
    """The kernel's time on the whole run and on the plain version's short run
    (CUDA events, median of ``reps``), MCMC.run end to end, the bounds."""
    n_chains, p = mcmc.n_chains, mcmc.data["X"].shape[1]

    def bound_of(h):
        n_sweeps, n_keep = h["n_burn"] + h["n_keep"] * h["n_thin"], h["n_keep"]
        n_bytes = 4 * (n_in + 2 * n_chains + n_chains * n_keep * (p + 3))
        n_flop = n_chains * flop_fn(n_sweeps, n_keep)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    run_ms, parts, sweeps_ms, ms = run_times(kernel_fn, mcmc.seed, args, kw, run_hyp, short, reps, split)
    n_sweeps = run_hyp["n_burn"] + run_hyp["n_keep"] * run_hyp["n_thin"]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = mcmc.run(engine="auto")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    e2e = statistics.median(walls)
    run_bound = bound_of(run_hyp)
    bound_ms, bound_by, n_flop, n_bytes = bound_of(short)
    log(tag, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of {reps}){split_text(parts)}, bound "
        f"{run_bound[0]:.4f} ms ({run_bound[1]}: {run_bound[2]:.3g} FLOP, {run_bound[3]:.3g} B); MCMC.run end to end "
        f"{1e3 * e2e:.3f} ms (median of {reps}); the same {n_sweeps} sweeps with one stored draw {sweeps_ms:.4f} ms")
    log(tag, f"{smi}: at n_burn {short['n_burn']}, n_iter {short['n_keep']}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
        f"(the check's call), bound {bound_ms:.5f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B)")
    log(tag, f"{smi}: ESS/s of beta {ess_beta / (run_ms / 1e3):.4g} on kernel time, {ess_beta / e2e:.4g} end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "run_ms": run_ms, **parts, "run_bound_ms": run_bound[0], "run_bound_by": run_bound[1],
            "run_e2e_ms": 1e3 * e2e}


def linreg_phase(dev, smi):
    """Example 3: one K6 launch, K6 against its plain version on 20 + 30 sweeps at
    full width, posterior means against the generic driver's, times."""
    from openmcmc_tpu_torch.fused import linreg

    tag = "linreg"
    X, y = example3_data()
    mcmc = linreg_mcmc(dev, X, y, R_CHAINS, R_BURN, R_ITER, R_SEED, 1e-3, 1e-3)
    res, launches = linreg_cell(tag, mcmc, "fused_linreg", "linreg")
    # K6's inputs as the dispatcher feeds them
    p = X.shape[1]
    Xd, yd = mcmc.data["X"], mcmc.data["y"][:, 0]
    plam, ptau = mcmc.data["P_lambda"].diag_, mcmc.data["P_tau"].diag_
    G, c, scal = linreg.sufficient_statistics(Xd, yd, plam, ptau)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [G, c, plam, torch.zeros(p, **f32), scal, torch.full((R_CHAINS,), 0.01, **f32),
            torch.full((R_CHAINS,), 1.0, **f32)]
    kw = dict(n_obs=float(R_N), a_lam=1e-3, b_lam=1e-3, a_tau=1e-3, b_tau=1e-3)
    short = dict(n_burn=20, n_keep=30, n_thin=1)
    gen = linreg_mcmc(dev, X, y, R_CHAINS, R_GEN_BURN, R_GEN_ITER, R_SEED, 1e-3, 1e-3)
    err, plain_ms, ess_beta, same = linreg_checks(tag, mcmc, res, linreg.linreg_sweeps_kernel,
                                                  linreg.linreg_sweeps_plain, args, kw, short, gen, chunk_size=8)

    def flop(n_sweeps, n_keep):
        return n_sweeps * k6_flop_per_sweep(p) + n_keep * K6_FLOP_PER_STORE

    entry = linreg_times(smi, tag, mcmc, linreg.linreg_sweeps_kernel, args, kw,
                         dict(n_burn=R_BURN, n_keep=R_ITER, n_thin=1), short, flop, p * p + 3 * p + 3, ess_beta,
                         plain_ms, reps=5)
    return {"launches": launches["linreg"], "max_abs_err": err, **same, **entry}


def linreg_wide_phase(dev, smi):
    """p = 256: one K5 launch and one of its store, K5 against its plain version
    on 2 + 3 sweeps at full width (lam, tau and log_post bit for bit), posterior
    means against a generic run of 256 chains, times with the sweep and store
    kernels apart. Also returns the stored w rows the store kernel turned into
    beta on a whole run, and V, for the store phase."""
    from openmcmc_tpu_torch.fused import spectral

    tag = "linreg_wide"
    X, y = wide_data()
    mcmc = linreg_mcmc(dev, X, y, W_CHAINS, W_BURN, W_ITER, W_SEED, 1.0, 1.0)
    res, launches = linreg_cell(tag, mcmc, "fused_linreg_spectral", "spectral_linreg", spectral_store=1)
    # K5's inputs as the dispatcher feeds them
    prep = spectral.prepare_linreg(mcmc.data["X"], mcmc.data["y"][:, 0], mu=np.zeros(W_P),
                                   plam_diag=mcmc.data["P_lambda"].diag_, ptau_diag=mcmc.data["P_tau"].diag_)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "s", "wmu", "cv")]
    args += [torch.full((W_CHAINS,), 0.01, **f32), torch.full((W_CHAINS,), 1.0, **f32)]
    kw = {k: float(np.float32(prep[k])) for k in ("yPy", "logdet_plam", "logdet_ptau")}
    kw.update(n_obs=float(W_N), a_lam=1.0, b_lam=1.0, a_tau=1.0, b_tau=1.0)
    short = dict(n_burn=2, n_keep=3, n_thin=1)
    gen = linreg_mcmc(dev, X, y, W_GEN_CHAINS, W_GEN_BURN, W_GEN_ITER, W_SEED, 1.0, 1.0)
    err, plain_ms, ess_beta, same = linreg_checks(tag, mcmc, res, spectral.spectral_linreg_sweeps_kernel,
                                                  spectral.spectral_linreg_sweeps_plain, args, kw, short, gen,
                                                  chunk_size=32, exact=True)

    def flop(n_sweeps, n_keep):
        return n_sweeps * (K5_FLOP_PER_COORD * W_P + K5_FLOP_PER_SWEEP) + n_keep * (2 * W_P * W_P + K5_FLOP_PER_STORE)

    run_hyp = dict(n_burn=W_BURN, n_keep=W_ITER, n_thin=1)
    entry = linreg_times(smi, tag, mcmc, spectral.spectral_linreg_sweeps_kernel, args, kw, run_hyp, short, flop,
                         W_P * W_P + 3 * W_P, ess_beta, plain_ms, reps=3, split=True)
    with store_inputs(spectral) as rows:
        spectral.spectral_linreg_sweeps_kernel(mcmc.seed, *args, **kw, **run_hyp)
    return {"launches": launches["spectral_linreg"], "max_abs_err": err, **same, **entry}, \
        launches["spectral_store"], rows[0], args[0]


@contextlib.contextmanager
def store_inputs(module):
    """Copies of the rows handed to ``module.spectral_store_kernel`` (its w, before
    the kernel turns them into beta in place) while the body runs; the wrapper
    is itself again during each call, so it counts its launch on itself."""
    real, rows = module.spectral_store_kernel, []

    def spy(w, V):
        rows.append(w.clone())
        module.spectral_store_kernel = real
        try:
            return real(w, V)
        finally:
            module.spectral_store_kernel = spy

    module.spectral_store_kernel = spy
    try:
        yield rows
    finally:
        module.spectral_store_kernel = real


def store_phase(smi, w, V, launches):
    """The store kernel alone at K5's and K9's shape (p = 256, the 256-column
    tile), on the w rows of a whole K5 run: against the plain product (rtol
    1e-5, atol 1e-5; the count of values that differ), its time (a fresh copy
    of the rows before each call, outside the events), the plain version's
    and torch.matmul's, and its bound."""
    from openmcmc_tpu_torch.fused import spectral

    w = w.reshape(-1, w.shape[-1])
    n_rows, p = w.shape
    got = spectral.spectral_store_kernel(w.clone(), V)
    want = spectral.spectral_store_plain(w, V)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5) or not bool(torch.all(torch.isfinite(got))):
        raise AssertionError("spectral_store: the kernel differs from the plain product")
    err, differing = float(torch.max(torch.abs(got - want))), int((got != want).sum())
    del got, want
    buf, times = torch.empty_like(w), []
    for _ in range(6):
        buf.copy_(w)
        times.append(cuda_call_ms(lambda: spectral.spectral_store_kernel(buf, V))[1])
    ms = statistics.median(times[1:])
    del buf
    plain_ms = cuda_ms(lambda: spectral.spectral_store_plain(w, V), 5)
    library_ms = cuda_ms(lambda: torch.matmul(w, V.T), 5)
    n_flop, n_bytes = 2.0 * n_rows * p * p, 4.0 * (2 * n_rows * p + p * p)
    bound_ms, bound_by = bound(n_bytes, n_flop)
    log("spectral_store", f"{n_rows} rows, p = {p}, in place: {differing} values differ from the plain product, max "
        f"abs err {err:.3g}; {smi}: kernel {ms:.4f} ms (median of 5, {n_flop / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, torch.matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_flop:.3g} "
        f"FLOP, {n_bytes:.3g} B)")
    return {"launches": sum(launches.values()), "launches_by_path": launches, "max_abs_err": err,
            "values_differing": differing, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def rw_mcmc(dev, kind, n_chains=None, n_burn=None, n_iter=None):
    """The random-walk cells in the port: ``rw``, the reference's example 2
    (bench_all.py:120-126), or ``rw_box``, p = 32 rows of 20 observations from
    N(2, 1) (numpy seed 0), tau = I and lambda = 0.01 I as Diagonals, mu = 0,
    h0 = 0, steps 0.1 (1 + i/32), proposals truncated to [-10, 10], adapting."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.samplers import RandomWalk

    mdl = Model([Normal("y", mean="h", precision="tau"), Normal("h", mean="mu", precision="lambda")])
    if kind == "rw":
        state = {"y": np.array([RW_Y]), "h": 200.0, "tau": np.eye(1) / 200.0, "mu": 160.0,
                 "lambda": np.eye(1) / 100.0}
        sampler = RandomWalk("h", mdl, step=5.0)
        dims = dict(n_chains=RW_CHAINS, n_burn=0, n_iter=RW_ITER, seed=0)
    else:
        state = {"y": np.random.default_rng(0).normal(2.0, 1.0, (B_P, B_N)), "h": np.zeros((B_P, 1)),
                 "tau": st.Diagonal(torch.ones(B_P)), "mu": np.zeros((B_P, 1)),
                 "lambda": st.Diagonal(torch.full((B_P,), 0.01))}
        step = (0.1 * (1.0 + np.arange(B_P) / B_P))[:, None]
        sampler = RandomWalk("h", mdl, step=step, domain_limits=[[-10.0, 10.0]], adapt_step=True)
        dims = dict(n_chains=B_CHAINS, n_burn=B_BURN, n_iter=B_ITER, seed=B_SEED)
    for k, v in (("n_chains", n_chains), ("n_burn", n_burn), ("n_iter", n_iter)):
        if v is not None:
            dims[k] = v
    return MCMC(state, [sampler], mdl, device=dev, **dims)


def mmala_data(N, p, noise, wide):
    """bench_all.py's mMALA data (numpy seed 0): X, beta_true, then noise, as
    (N, p) and (N, 1); ``wide`` draws beta_true as a (p,) vector first."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, p))
    beta = rng.normal(size=p) if wide else rng.normal(size=(p, 1))
    y = (X @ beta).reshape(N, 1) + noise * rng.normal(size=(N, 1))
    return X, y


def mmala_mcmc(dev, wide, n_chains=None, n_burn=None, n_iter=None):
    """The mMALA cells in the port: y ~ N(X beta, (tau P)^-1), beta ~ N(0, (one
    P0)^-1), P = 100 I, P0 = 0.01 I, tau = one = 1 (bench_all.py:129-144), at
    N = 100, p = 5, step 1; or ``wide``: N = 2048, p = 256, noise sd 0.1, step 1
    adapting toward 0.574."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix
    from openmcmc_tpu_torch.samplers import ManifoldMALA

    N, p = (MW_N, MW_P) if wide else (M_N, M_P)
    X, y = mmala_data(N, p, 0.1, wide)
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P", "tau")),
        Normal("beta", mean="mu0", precision=ScaledMatrix("P0", "one")),
    ])
    state = {"y": y, "X": X, "beta": np.zeros((p, 1)), "P": st.Diagonal(torch.full((N,), 100.0)), "tau": 1.0,
             "P0": st.Diagonal(torch.full((p,), 0.01)), "mu0": np.zeros((p, 1)), "one": 1.0}
    sampler = ManifoldMALA("beta", mdl, step=1.0, adapt_step=wide)
    if wide:
        dims = dict(n_chains=MW_CHAINS, n_burn=MW_BURN, n_iter=MW_ITER, seed=MW_SEED)
    else:
        dims = dict(n_chains=M_CHAINS, n_burn=M_BURN, n_iter=M_ITER, seed=0)
    for k, v in (("n_chains", n_chains), ("n_burn", n_burn), ("n_iter", n_iter)):
        if v is not None:
            dims[k] = v
    return MCMC(state, [sampler], mdl, device=dev, **dims)


def mmala_posterior(wide):
    """The analytic posterior mean and sd of beta, f64."""
    N, p = (MW_N, MW_P) if wide else (M_N, M_P)
    X, y = mmala_data(N, p, 0.1, wide)
    A = 100.0 * X.T @ X + 0.01 * np.eye(p)
    return np.linalg.solve(A, 100.0 * X.T @ y).reshape(-1), np.sqrt(np.diag(np.linalg.inv(A)))


def compare_mh(got, want, draw):
    """Per-chain agreement of a Metropolis kernel with its plain version: the
    draws (rtol 1e-4, atol 1e-5), log_post (1e-4 relative) and every accept
    decision; returns (agreeing chains, max abs err of the draws)."""
    g, w = got[draw], want[draw]
    ok = torch.isclose(g, w, rtol=1e-4, atol=1e-5).reshape(g.shape[0], -1).all(1)
    ok &= (torch.abs(got["log_post"] - want["log_post"]) <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0)).all(1)
    ok &= (got["accept"] == want["accept"]).all(1)
    return int(ok.sum()), float(torch.max(torch.abs(g - w)))


def mh_cell(tag, mcmc, engine, kernel, name, **others):
    """One Metropolis cell's run: MCMC.run(engine="auto") with the counts at 0
    around it, one launch of ``kernel``, ``others`` (the counts of any other
    kernel the path launches) and no other, the store's shape and finiteness,
    the statistics' shapes."""
    n_chains, n_iter, p = mcmc.n_chains, mcmc.n_iter, mcmc.initial_chain_state[name].shape[0]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only(kernel, 1, **others):
        raise AssertionError(f"{tag}: engine {res.engine}, kernel launches {launches}")
    draws = res.store[name]
    if tuple(draws.shape) != (n_chains, n_iter, p, 1) or tuple(res.log_post.shape) != (n_chains, n_iter):
        raise AssertionError(f"{tag}: store {tuple(draws.shape)}, log_post {tuple(res.log_post.shape)}")
    for v in (draws, res.log_post):
        if not bool(torch.all(torch.isfinite(v))) or v.device.type != DEVICE_TYPE:
            raise AssertionError(f"{tag}: non-finite values, or not on the card")
    stats = res.stats[name]
    if tuple(stats["accept"].shape) != (n_chains,) or not bool(torch.all(stats["proposal"] == mcmc.n_burn + n_iter)):
        raise AssertionError(f"{tag}: statistics {[(k, tuple(v.shape)) for k, v in stats.items()]}")
    acc = float(res.acceptance[name].mean())
    log(tag, f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, {name} "
        f"{tuple(draws.shape)}, first run {wall:.3f} s; acceptance {acc:.2f} % over burn-in and sampling")
    return res, launches, acc


def mh_checks(tag, mcmc, res, name, kernel_fn, plain_fn, args, kw, short, gen_mcmc, draw, chunk_size, exact=None,
              keep_from=0, bits=False):
    """The kernel against its plain version on a short run at full width
    (>= 99.9 % of chains agree; with ``bits`` every chain's log_post, accept
    decisions, accept_total and log_step bit for bit), the count of draws that
    differ from the plain version's, the fused run's posterior means against the
    generic twin's (which launches no kernel) and, given ``exact`` = (mean, sd),
    against the analytic posterior over the draws from ``keep_from`` on, each
    within 5 MC sd."""
    fused = moments({name: res.store[name][..., 0]}, chunk_size)
    ess = float(fused[name][2].mean())
    exact_z = None
    if exact is not None:
        kept = moments({name: res.store[name][:, keep_from:, :, 0]}, chunk_size)[name]
        mean = torch.as_tensor(exact[0], dtype=torch.float64, device=kept[0].device)
        exact_z = float(torch.max(torch.abs(kept[0] - mean) / (kept[1] / torch.sqrt(kept[2]))))
        if not exact_z < 5.0:
            raise AssertionError(f"{tag}: posterior means off the analytic posterior by {exact_z:.2f} MC sd")
    del res
    torch.cuda.empty_cache()
    got = kernel_fn(mcmc.seed, *args, **kw, **short)
    want, plain_ms = cuda_call_ms(lambda: plain_fn(mcmc.seed, *args, **kw, **short))
    agree, err = compare_mh(got, want, draw)
    same = equal_chains(got, want, (draw, "log_post", "accept", "accept_total", "log_step"))
    same_rest = equal_chains(got, want, ("log_post", "accept", "accept_total", "log_step"))
    draw_diff = int((got[draw] != want[draw]).sum())
    del got, want
    n_chains = mcmc.n_chains
    if agree < 0.999 * n_chains:
        raise AssertionError(f"{tag}: only {agree} of {n_chains} chains agree with the plain version")
    if bits and same_rest != n_chains:
        raise AssertionError(f"{tag}: log_post, accept, accept_total and log_step of only {same_rest} of {n_chains} "
                             "chains equal the plain version's bit for bit")
    reset_launches()
    t0 = time.perf_counter()
    gen = gen_mcmc.run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches()
    if gen.engine != "generic" or any(gen_launches.values()):
        raise AssertionError(f"{tag}: the generic twin ran {gen.engine} with kernel launches {gen_launches}")
    z = moments_z(fused, moments({name: gen.store[name][..., 0]}, chunk_size))
    gen_acc = float(gen.acceptance[name].mean())
    del gen
    torch.cuda.empty_cache()
    if not z < 5.0:
        raise AssertionError(f"{tag}: posterior means off the generic run's by {z:.2f} MC sd")
    log(tag, f"kernel and plain version agree on {agree} of {n_chains} chains at n_burn {short['n_burn']}, n_iter "
        f"{short['n_keep']} (rtol 1e-4, every accept decision; {same} bit for bit, {same_rest} without {draw}), max "
        f"abs err {err:.3g}, {draw_diff} {draw} values differ; means of {name} within "
        f"{z:.2f} MC sd of the generic run's (limit 5; generic run of {gen_mcmc.n_chains} chains, {gen_mcmc.n_burn} + "
        f"{gen_mcmc.n_iter} sweeps, {gen_wall:.3f} s, acceptance {gen_acc:.2f} %)"
        + ("" if exact_z is None else f" and within {exact_z:.2f} MC sd of the analytic posterior")
        + f"; mean ESS of {name} {ess:.1f} over {n_chains * mcmc.n_iter} draws")
    return err, plain_ms, ess, same, {"bit_identical_chains": same, f"{draw}_values_differing": draw_diff}


def mh_times(smi, tag, mcmc, kernel_fn, args, kw, run_hyp, short, flop_fn, n_in, p, ess, acc, plain_ms, reps,
             split=False):
    """The kernel's time on the whole run (with ``split``, its sweep and store
    kernels apart), on the same sweeps with one stored draw and on the plain
    version's short run (CUDA events, median of ``reps``), MCMC.run end to end,
    the bounds."""
    n_chains = mcmc.n_chains

    def bound_of(h):
        n_sweeps, n_keep = h["n_burn"] + h["n_keep"] * h["n_thin"], h["n_keep"]
        n_bytes = 4 * (n_in + n_chains * n_keep * (p + 2) + 2 * n_chains)
        n_flop = n_chains * flop_fn(n_sweeps, n_keep)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    run_ms, parts, sweeps_ms, ms = run_times(kernel_fn, mcmc.seed, args, kw, run_hyp, short, reps, split)
    n_sweeps = run_hyp["n_burn"] + run_hyp["n_keep"] * run_hyp["n_thin"]
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = mcmc.run(engine="auto")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    e2e = statistics.median(walls)
    run_bound = bound_of(run_hyp)
    bound_ms, bound_by, n_flop, n_bytes = bound_of(short)
    log(tag, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of {reps}){split_text(parts)}, bound "
        f"{run_bound[0]:.4f} ms ({run_bound[1]}: {run_bound[2]:.3g} FLOP, {run_bound[3]:.3g} B); MCMC.run end to end "
        f"{1e3 * e2e:.3f} ms (median of {reps}); the same {n_sweeps} sweeps with one stored draw {sweeps_ms:.4f} ms")
    log(tag, f"{smi}: at n_burn {short['n_burn']}, n_iter {short['n_keep']}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
        f"(the check's call), bound {bound_ms:.5f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B)")
    log(tag, f"{smi}: acceptance {acc:.2f} %; ESS/s {ess / (run_ms / 1e3):.4g} on kernel time, {ess / e2e:.4g} "
        "end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "run_ms": run_ms, **parts, "run_bound_ms": run_bound[0], "run_bound_by": run_bound[1],
            "run_e2e_ms": 1e3 * e2e}


def rw_phase(dev, smi, kind):
    """``rw`` (example 2, K7 at p = 1) or ``rw_box`` (K7 at p = 32, truncated,
    adapting): one K7 launch, K7 against its plain version, posterior means
    against the generic twin's (and, for example 2, the analytic posterior)."""
    from openmcmc_tpu_torch.fused import random_walk as rw

    mcmc = rw_mcmc(dev, kind)
    res, launches, acc = mh_cell(kind, mcmc, "fused_random_walk", "random_walk", "h")
    # K7's inputs as the dispatcher feeds them
    sampler = mcmc.samplers[0]
    p = mcmc.data["y"].shape[0]
    box = None if sampler.domain_limits is None else (np.full(p, -10.0), np.full(p, 10.0))
    scal, kw = rw.prepare(mcmc.data["y"], mu=mcmc.data["mu"][:, 0], tau=st_diag(mcmc.data["tau"], p),
                          lam=st_diag(mcmc.data["lambda"], p), step=sampler.step_size,
                          h0=mcmc.initial_chain_state["h"][:, 0], domain=box, device=dev)
    kw.update(adapt=sampler.adapt_step, target=sampler.target_accept, rate=sampler.adapt_rate)
    if kind == "rw":
        # the analytic conjugate posterior of h, held against the draws after the
        # first 200 (the chains start 7 posterior sd away, at h0 = 200)
        prec = len(RW_Y) / 200.0 + 1.0 / 100.0
        exact = (np.array([(sum(RW_Y) / 200.0 + 160.0 / 100.0) / prec]), np.array([prec ** -0.5]))
        short, gen, chunk = dict(n_burn=0, n_keep=50, n_thin=1), rw_mcmc(dev, kind), 8
    else:
        short, exact, chunk = dict(n_burn=20, n_keep=30, n_thin=1), None, 32
        gen = rw_mcmc(dev, kind, n_chains=B_GEN_CHAINS, n_burn=B_GEN_BURN, n_iter=B_GEN_ITER)
    err, plain_ms, ess, same, _ = mh_checks(kind, mcmc, res, "h", rw.rw_sweeps_kernel, rw.rw_sweeps_plain,
                                            (scal, mcmc.n_chains), kw, short, gen, "h", chunk, exact=exact,
                                            keep_from=200)
    per_coord = K7_FLOP_PER_TRUNC_COORD if box is not None else K7_FLOP_PER_COORD

    def flop(n_sweeps, n_keep):
        return n_sweeps * (per_coord * p + K7_FLOP_PER_SWEEP)

    entry = mh_times(smi, kind, mcmc, rw.rw_sweeps_kernel, (scal, mcmc.n_chains), kw,
                     dict(n_burn=mcmc.n_burn, n_keep=mcmc.n_iter, n_thin=1), short, flop, scal.numel(), p, ess, acc,
                     plain_ms, reps=3)
    return {"launches": launches["random_walk"], "max_abs_err": err, "acceptance_pct": acc,
            "bit_identical_chains": same, **entry}


def st_diag(value, p):
    """The (p,) diagonal of a constant diagonal precision entry, on the host."""
    from openmcmc_tpu_torch.linalg import structured as st

    d = st.diag(st.as_structured(value)).detach().cpu().double().numpy().reshape(-1)
    return np.broadcast_to(d, (p,)).copy()


def mmala_phase(dev, smi, wide):
    """``mmala`` (K8, p = 5) or ``mmala_wide`` (K9, p = 256, and its store): one
    launch each, the kernel against its plain version (K9: log_post, accept
    decisions, accept_total and log_step bit for bit), posterior means against
    the generic twin's and the analytic posterior c = A^-1 v; K9's times with
    the sweep and store kernels apart."""
    from openmcmc_tpu_torch.fused import mmala, spectral

    tag = "mmala_wide" if wide else "mmala"
    mcmc = mmala_mcmc(dev, wide)
    engine, kernel = ("fused_mmala_spectral", "spectral_mmala") if wide else ("fused_mmala", "mmala")
    res, launches, acc = mh_cell(tag, mcmc, engine, kernel, "beta", **({"spectral_store": 1} if wide else {}))
    sampler = mcmc.samplers[0]
    N, p = mcmc.data["X"].shape
    host = dict(tau=1.0, lam=1.0, ptau_diag=mcmc.data["P"].diag_, plam_diag=mcmc.data["P0"].diag_,
                mu0=mcmc.data["mu0"][:, 0], beta0=mcmc.initial_chain_state["beta"][:, 0])
    mh = dict(step=1.0, adapt=sampler.adapt_step, target=sampler.target_accept, rate=sampler.adapt_rate)
    if wide:
        tensors, kw = spectral.mmala_inputs(spectral.prepare_mmala(mcmc.data["X"], mcmc.data["y"], **host), dev)
        args, kernel_fn, plain_fn = (*tensors, mcmc.n_chains), spectral.spectral_mmala_sweeps_kernel, \
            spectral.spectral_mmala_sweeps_plain
        kw.update(mh)
        short, chunk = dict(n_burn=2, n_keep=3, n_thin=1), 32
        gen = mmala_mcmc(dev, wide, n_chains=MW_GEN_CHAINS, n_burn=MW_GEN_BURN, n_iter=MW_GEN_ITER)
        n_in = p * p + 4 * p

        def flop(n_sweeps, n_keep):
            return n_sweeps * (K9_FLOP_PER_COORD * p + K9_FLOP_PER_SWEEP) + n_keep * (2 * p * p + K9_FLOP_PER_STORE)
    else:
        prep = mmala.prepare(mcmc.data["X"], mcmc.data["y"], **host)
        args, kernel_fn, plain_fn = (torch.from_numpy(prep["scal"]).to(dev), mcmc.n_chains), \
            mmala.mmala_sweeps_kernel, mmala.mmala_sweeps_plain
        kw = dict(p=p, n_obs=float(N), **mh)
        short, chunk = dict(n_burn=20, n_keep=30, n_thin=1), 8
        gen = mmala_mcmc(dev, wide, n_burn=M_GEN_BURN, n_iter=M_GEN_ITER)
        n_in = prep["scal"].size

        def flop(n_sweeps, n_keep):
            return n_sweeps * k8_flop_per_sweep(p)
    err, plain_ms, ess, _, same = mh_checks(tag, mcmc, res, "beta", kernel_fn, plain_fn, args, kw, short, gen, "beta",
                                            chunk, exact=mmala_posterior(wide), bits=wide)
    entry = mh_times(smi, tag, mcmc, kernel_fn, args, kw, dict(n_burn=mcmc.n_burn, n_keep=mcmc.n_iter, n_thin=1),
                     short, flop, n_in, p, ess, acc, plain_ms, reps=3, split=wide)
    out = {"launches": launches[kernel], "max_abs_err": err, "acceptance_pct": acc, **same, **entry}
    return (out, launches["spectral_store"]) if wide else out


def gamma_elem_phase(dev):
    """gamma_elem_draws (gamma_mt_elem, the Gamma draw K10 inlines) against its
    plain version over mixture_large's precision counters (site 2 on, the four
    groups of K = 16 per chain and sweep), shapes a* in [1, 4000) skewed to 1."""
    from openmcmc_tpu_torch.fused import prng

    n_sweeps, groups = XL_BURN + XL_ITER, XL_K // 4
    rows = torch.arange(XL_CHAINS * n_sweeps * groups, dtype=torch.int64)
    ctr = torch.stack([rows // (n_sweeps * groups), rows // groups % n_sweeps, torch.full_like(rows, 2),
                       rows % groups], 1).to(torch.int32).to(dev).contiguous()
    n = ctr.shape[0]
    gen = torch.Generator().manual_seed(3)
    a = (1.0 + 3999.0 * torch.rand((n, 4), generator=gen) ** 3).to(dev)
    rate = (0.5 + 5000.0 * torch.rand((n, 4), generator=gen)).to(dev)
    got = prng.gamma_elem_draws(SEED, ctr, a, rate)
    want = prng.gamma_elem_draws_plain(SEED, ctr, a, rate)
    torch.cuda.synchronize()
    rel = float(torch.max(torch.abs(got - want) / torch.abs(want)))
    if not bool(torch.all(torch.isfinite(got) & (got > 0))) or rel > 1e-6:
        raise AssertionError(f"gamma_elem_draws: differs from the plain version by {rel:.3g} (relative)")
    err = float(torch.max(torch.abs(got - want)))
    ms = cuda_ms(lambda: prng.gamma_elem_draws(SEED, ctr, a, rate), 5)
    plain_ms = cuda_ms(lambda: prng.gamma_elem_draws_plain(SEED, ctr, a, rate), 3)
    bound_ms, bound_by = bound(n * 64, n * K2G_FLOP_PER_ROW)
    log("gamma_elem", f"{n} rows: within {rel:.3g} rel of the plain version (limit 1e-6); mean of Gamma(a*) * rate "
        f"over a* {float((got * rate / a).mean()):.5f} (1 expected); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def gamma_phase(dev, smi):
    """K12 through its entry point ``linalg.gamma.gamma`` on a CUDA tensor of 2^24
    shapes tiled over G_SHAPES, one launch and no other; every value against the
    plain version on the same Philox bits; a KS test per shape on 10^6 of the
    kernel's draws; the kernel, the plain version and torch._standard_gamma
    timed by CUDA events."""
    from scipy.stats import gamma as sp_gamma, kstest

    from openmcmc_tpu_torch.linalg import gamma

    shapes = torch.tensor(G_SHAPES, dtype=torch.float32, device=dev)
    a = shapes.repeat(G_N // len(G_SHAPES) + 1)[:G_N].contiguous()
    reset_launches()
    got = gamma.gamma(SEED, a)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != only("gamma", 1):
        raise AssertionError(f"gamma: kernel launches {launches}, not one gamma launch")
    want, plain_ms = cuda_call_ms(lambda: gamma.gamma_plain(SEED, a))
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
    if not bool(close.all()) or not bool(torch.all(got > 0.0)):
        raise AssertionError(f"gamma: {int((~close).sum())} of {G_N} draws differ from the plain version "
                             "(rtol 1e-4, atol 1e-5), or a draw is not positive")
    err = float(torch.max(torch.abs(got - want)))
    del want
    worst_p = 1.0
    for i, shape in enumerate(G_SHAPES):
        draws = got[i::len(G_SHAPES)][:G_KS].double().cpu().numpy()
        p = float(kstest(draws, sp_gamma(shape).cdf).pvalue)
        if not p > 1e-3:
            raise AssertionError(f"gamma: KS test of shape {shape} on {draws.size} draws, p = {p:.3g}")
        worst_p = min(worst_p, p)
    ms = cuda_ms(lambda: gamma.gamma(SEED, a), 5)
    plain_ms = min(plain_ms, cuda_ms(lambda: gamma.gamma_plain(SEED, a), 5))
    library_ms = cuda_ms(lambda: torch._standard_gamma(a), 5)
    rounds = int(gamma.gamma_rounds(SEED, a).sum())
    n_flop = K12_FLOP_SETUP * G_N + K12_FLOP_PER_ROUND * rounds + K12_FLOP_BOOST * int((a < 1.0).sum())
    bound_ms, bound_by = bound(8 * G_N, n_flop)
    log("gamma", f"{G_N} draws, shapes {G_SHAPES}: one K12 launch; every value within rtol 1e-4, atol 1e-5 of the "
        f"plain version (max abs err {err:.3g}); KS p >= {worst_p:.3g} per shape on {G_KS} draws (limit 1e-3)")
    log("gamma", f"{smi}: kernel {ms:.4f} ms (median of 5), plain {plain_ms:.3f} ms, torch._standard_gamma "
        f"{library_ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms ({bound_by}: {n_flop:.3g} FLOP at "
        f"{rounds / G_N:.4f} rounds a draw to the first acceptance, {8 * G_N:.3g} B)")
    return {"launches": launches["gamma"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


@contextlib.contextmanager
def calls_of(module, name):
    """Record the (args, kw) of every call of ``module.name``, a kernel's routing
    function (the counted kernel wrapper below it is untouched), while the
    body runs."""
    real, calls = getattr(module, name), []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def launch_events(module, name):
    """CUDA events recorded on the current stream just before and just after
    every call of ``module.name``, a kernel's routing function, while the body
    runs, as (start, stop) pairs: each launch's device time once the body has
    synchronised. ``module.name`` is itself again during each call, so a counted
    kernel wrapper counts its launch on itself."""
    real, marks = getattr(module, name), []

    def timed(*args, **kw):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        setattr(module, name, real)
        try:
            out = real(*args, **kw)
        finally:
            setattr(module, name, timed)
        stop.record()
        marks.append((start, stop))
        return out

    setattr(module, name, timed)
    try:
        yield marks
    finally:
        setattr(module, name, real)


def warm_rows_agree(tag, kernel_fn, plain_fn, call, rows, draw="b", exact=False, **override):
    """The kernel against its plain version on the inputs a resume built:
    ``call`` is the (args, kw) the runner passed the routing function, ``rows``
    the per-chain warm inputs among them, which must differ across chains (at
    least 99 % distinct rows, so that a kernel reading one chain's row for all
    would show); ``override`` shortens the run. Every chain agrees within rtol
    1e-4, atol 1e-5 (log_post 1e-4 relative) or, ``exact``, bit for bit."""
    args, kw = call
    kw = {k: v for k, v in kw.items() if k != "bit_source"} | override
    chains = rows[0].shape[0]
    distinct = min(torch.unique(r.reshape(chains, -1), dim=0).shape[0] for r in rows)
    if distinct < 0.99 * chains:
        raise AssertionError(f"resume {tag}: the warm rows are not per chain ({distinct} distinct of {chains})")
    got = kernel_fn(*args, **kw)
    want = plain_fn(*args, **kw)
    torch.cuda.synchronize()
    if exact:
        agree, err = int((got == want).flatten(1).all(1).sum()), float(torch.max(torch.abs(got - want)))
    else:
        agree, err = compare(got, want, draw)
    if agree != chains:
        raise AssertionError(f"resume {tag}: on the warm rows {chains - agree} of {chains} chains differ from the "
                             "plain version")
    log("resume", f"{tag}: the kernel on the resume's warm rows ({distinct} distinct of {chains} chains, "
        f"n_keep {kw['n_keep'] if 'n_keep' in kw else kw['config'].prm.n_keep}) agrees with the plain version on "
        f"every chain ({'bit for bit' if exact else f'rtol 1e-4, max abs err {err:.3g}'})")
    return err


def short_resume(tag, mcmc, engine, kernel, log_p_state, router, replay, limit=1e-4):
    """A short fused run and its resume, the counts at 0 around the resume: one
    launch of ``kernel`` and no other, the same engine, no burn-in (the
    stores' length), and log_post equal to Model.log_p at stored draws of 3
    chains x 3 draws within ``limit`` relative (``log_p_state(state)``
    completes a draw's state); then ``replay`` holds the kernel against its
    plain version on the call the resume made to ``router`` (module, name)."""
    first = mcmc.run(engine="auto")
    reset_launches()
    with calls_of(*router) as calls:
        res = mcmc.run(engine="auto", resume=first)
    torch.cuda.synchronize()
    launches = read_launches()
    if res.engine != engine or first.engine != engine or launches != only(kernel, 1):
        raise AssertionError(f"resume {tag}: engines {first.engine}, {res.engine}, kernel launches {launches}")
    if res.final_key in (first.final_key, mcmc.seed) or tuple(res.log_post.shape) != (mcmc.n_chains, mcmc.n_iter):
        raise AssertionError(f"resume {tag}: final_key {res.final_key} or log_post {tuple(res.log_post.shape)}")
    worst = 0.0
    for c in (0, 1, mcmc.n_chains - 1):
        for t in (0, mcmc.n_iter // 2, mcmc.n_iter - 1):
            state = dict(mcmc.data)
            state.update({name: v[c, t] for name, v in res.store.items()})
            want = float(mcmc.model.log_p(log_p_state(state)))
            worst = max(worst, abs(float(res.log_post[c, t]) - want) / max(1.0, abs(want)))
    if not worst <= limit:
        raise AssertionError(f"resume {tag}: log_post differs from Model.log_p by {worst:.3g} (relative)")
    log("resume", f"{tag}: {mcmc.n_chains} chains, {mcmc.n_burn} + {mcmc.n_iter} sweeps, then a resume of "
        f"{mcmc.n_iter}: engine {res.engine}, kernel launches {launches}; log_post within {worst:.3g} (relative) of "
        f"Model.log_p at 3 chains x 3 draws (limit {limit:g})")
    replay(calls[-1])
    return launches[kernel]


def resume_phase(dev, smi, fused_moments):
    """Operations on the card: the flagship through run_chunked (5 chunks, each
    one K1 launch, a checkpoint after each), its posterior against the main
    path's single run, a resume from the loaded checkpoint against a resume
    from the live result; short resumes of K4 truncated, K6 and K11; a generic
    resume of the flagship twin, one K3 launch a sweep."""
    import tempfile

    from openmcmc_tpu_torch import _build
    from openmcmc_tpu_torch.checkpoint import load_checkpoint
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs, linreg as lr, rj, spectral
    from openmcmc_tpu_torch.mcmc import next_key

    mcmc = build_mcmc(dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = f"{tmp}/flagship.npz"
        reset_launches()
        t0 = time.perf_counter()
        with calls_of(spectral, "smoother_sweeps") as k1_calls:
            res = mcmc.run_chunked(RS_CHUNKS, checkpoint_path=path, progress=True, engine="auto")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if res.engine != "fused_smoother_spectral" or launches != only("spectral_smoother", RS_CHUNKS,
                                                                         spectral_store=RS_CHUNKS):
            raise AssertionError(f"resume: run_chunked ran {res.engine} with kernel launches {launches}")
        check_store(res, "run_chunked")
        keys = [mcmc.seed]
        for _ in range(RS_CHUNKS):
            keys.append(next_key(keys[-1]))
        if res.final_key != keys[-1] or len(set(keys)) != RS_CHUNKS + 1:
            raise AssertionError(f"resume: final_key {res.final_key}, chunk keys {keys}")
        z = moments_z(posterior_moments(res), fused_moments)
        if not z < 5.0:
            raise AssertionError(f"resume: run_chunked's posterior means off the single run's by {z:.2f} MC sd")
        restored = load_checkpoint(path, device=dev)
    mcmc.n_iter = 50
    live, again = mcmc.run(resume=res, engine="auto"), mcmc.run(resume=restored, engine="auto")
    if live.final_key != again.final_key or not all(torch.equal(live.store[k], again.store[k]) for k in live.store):
        raise AssertionError("resume: a resume from the restored checkpoint differs from one from the live result")
    if not torch.equal(live.log_post, again.log_post):
        raise AssertionError("resume: log_post of the restored resume differs")
    log("resume", f"run_chunked({RS_CHUNKS}, engine='auto') of {N_CHAINS} chains, {N_BURN} + {N_ITER} sweeps: "
        f"{launches['spectral_smoother']} K1 launches, {wall:.3f} s with a checkpoint per chunk; chunk keys "
        f"{keys[1:]}; means of b, lambda, tau within {z:.2f} MC sd of the single run's (limit 5); a 50-draw resume "
        "from the loaded checkpoint equals the live resume bit for bit")
    del res, restored, live, again
    torch.cuda.empty_cache()
    k1_args = k1_calls[-1][0]
    warm_rows_agree("K1, last chunk", spectral.smoother_sweeps_kernel, spectral.smoother_sweeps_plain, k1_calls[-1],
                    k1_args[5:7], n_keep=RS_SHORT // 2)

    trunc = truncated_mcmc(dev)
    trunc.n_burn, trunc.n_iter = RS_SHORT, RS_SHORT
    n_k4 = short_resume(
        "K4 truncated", trunc, "fused_gmrf_smoother_truncated", "gmrf_smoother", lambda s: s, (gs, "gmrf_smoother"),
        lambda call: warm_rows_agree("K4 truncated", gs.gmrf_smoother_kernel, gs.gmrf_smoother_plain, call,
                                     (*call[0][7:9], call[1]["b_init"])))
    X, y = example3_data()
    lin = linreg_mcmc(dev, X, y, R_CHAINS, RS_SHORT, RS_SHORT, R_SEED, 1e-3, 1e-3)
    # K6's log_post takes tau's form as yPy - 2 c'b + b'Gb in float32 (the JAX
    # kernel's form): at example 3 it cancels about 550-fold (yPy 517 against a
    # residual sum of 0.95), and its rounding moves log_post by up to 1.7e-4
    # relative (0.01 at |log_post| 68, the plain version on the CPU alike); the
    # limit allows eight ulps of yPy at tau 130
    n_k6 = short_resume(
        "K6", lin, "fused_linreg", "linreg", lambda s: s, (lr, "linreg_sweeps"),
        lambda call: warm_rows_agree("K6", lr.linreg_sweeps_kernel, lr.linreg_sweeps_plain, call, call[0][6:8],
                                     draw="beta"), limit=5e-4)
    rjm = rj_mcmc(dev, True, n_iter=RS_SHORT, store_names=("n_basis", "beta", "theta", "omega", "tau_y"))
    g = rjm.samplers[3].state_birth_function.__self__

    def with_basis(state):
        state["B"] = g.make(state["X"], state["theta"], state["omega"], state["n_basis"])
        return state

    n_k11 = short_resume(
        "K11", rjm, "fused_rj", "rj", with_basis, (rj, "rj_sweeps"),
        lambda call: warm_rows_agree("K11", rj.rj_sweeps_kernel, rj.rj_sweeps_plain, call, call[0][1:2], exact=True))

    twin = build_mcmc(dev, n_chains=RS_GEN_CHAINS)
    twin.n_iter = 100
    first = twin.run()
    twin.n_iter = RS_GEN_ITER
    reset_launches()
    t0 = time.perf_counter()
    gen = twin.run(resume=first)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_launches = read_launches()
    if gen.engine != "generic" or gen_launches != only("tridiag_canonical", RS_GEN_ITER):
        raise AssertionError(f"resume: the generic resume ran {gen.engine} with kernel launches {gen_launches}")
    z_gen = moments_z(posterior_moments(gen), fused_moments)
    if not z_gen < 5.0:
        raise AssertionError(f"resume: the generic resume's posterior means off the fused run's by {z_gen:.2f} MC sd")
    log("resume", f"{smi}: generic resume of the flagship at {RS_GEN_CHAINS} chains ({N_BURN} + 100 sweeps, then "
        f"{RS_GEN_ITER}): {gen_launches['tridiag_canonical']} K3 launches, {gen_wall:.3f} s; means of b, lambda, tau "
        f"within {z_gen:.2f} MC sd of the fused run's (limit 5)")
    return {"spectral_smoother": launches["spectral_smoother"], "gmrf_smoother": n_k4, "linreg": n_k6, "rj": n_k11,
            "tridiag_canonical": gen_launches["tridiag_canonical"]}


def mixture_mcmc(dev, kind, n_chains=None, store_names=("means", "lams"), gen_burn=None, gen_iter=None):
    """The mixture cells in the port: bench_all.py's ``mixture`` (n = 200, K = 2,
    numpy seed 0, RandomWalkLoop step 0.3 on [-20, 20]^2), ``mixture_conjugate``
    (its conjugate means) or ``mixture_large`` (n = 100,000, K = 16, conjugate
    means, components at linspace(-22.5, 22.5) with sd 0.7), seed 0.
    ``store_names=None`` keeps the driver's default store set, Z included."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Categorical, Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import MixtureParameterMatrix, MixtureParameterVector
    from openmcmc_tpu_torch.samplers import MixtureAllocation, NormalGamma, NormalNormal, RandomWalkLoop

    rng = np.random.default_rng(0)
    if kind == "mixture_large":
        n, k, chains, n_burn, n_iter = XL_N, XL_K, XL_CHAINS, XL_BURN, XL_ITER
        true_means = np.linspace(-22.5, 22.5, k)
        y = rng.normal(true_means[rng.integers(0, k, n)], 0.7).reshape(n, 1)
        z0 = np.clip(((y.ravel() + 24.0) / 3.0).astype(np.int32), 0, k - 1).reshape(n, 1)
        means0 = (true_means + rng.normal(0, 0.3, k)).reshape(k, 1)
    else:
        n, k, chains, n_burn, n_iter = X_N, X_K, X_CHAINS, X_BURN, X_ITER
        alloc = rng.integers(0, k, n)
        y = rng.normal(np.array([-2.0, 3.0])[alloc], 1.0 / np.sqrt(np.array([4.0, 1.0])[alloc])).reshape(n, 1)
        z0, means0 = (y > 0).astype(np.int32), np.array([-1.0, 1.0]).reshape(k, 1)
    mdl = Model([
        Normal("y", mean=MixtureParameterVector(param="means", allocation="Z"),
               precision=MixtureParameterMatrix(param="lams", allocation="Z")),
        Categorical("Z", prob="prior"),
        Normal("means", mean="mu0", precision="P0"),
        Gamma("lams", shape="a0", rate="b0"),
    ])
    if kind == "mixture":
        means_sampler = RandomWalkLoop("means", mdl, step=0.3, domain_limits=np.tile([[-20.0, 20.0]], (k, 1)))
    else:
        means_sampler = NormalNormal("means", mdl)
    samplers = [MixtureAllocation("Z", mdl, response_param="y"), means_sampler, NormalGamma("lams", mdl)]
    state = {"y": y, "Z": z0, "means": means0, "lams": np.ones((k, 1)), "prior": np.full((n, k), 1.0 / k),
             "mu0": np.zeros((k, 1)), "P0": st.Diagonal(torch.full((k,), 0.01)), "a0": np.full((k, 1), 2.0),
             "b0": np.full((k, 1), 1.0)}
    if kind != "mixture_large":
        state["prior"] = np.full((n, k), 0.5)
    return MCMC(state, samplers, mdl, n_burn=n_burn if gen_burn is None else gen_burn,
                n_iter=n_iter if gen_iter is None else gen_iter, n_chains=n_chains or chains, seed=0,
                store_names=None if store_names is None else list(store_names), device=dev)


def mixture_inputs(mcmc, dev):
    """K10's inputs as the dispatcher feeds them, and its keywords."""
    from openmcmc_tpu_torch.fused import mixture
    from openmcmc_tpu_torch.samplers import NormalNormal

    data, init = mcmc.data, mcmc.initial_chain_state
    k = data["prior"].shape[1]
    conjugate = isinstance(mcmc.samplers[1], NormalNormal)
    domain = None if conjugate else tuple(mcmc.samplers[1].domain_limits.T)
    scal, packed, kw = mixture.prepare(data["y"], data["prior"], data["mu0"], data["P0"].diag_, data["a0"], data["b0"],
                                       init["means"], init["lams"], domain=domain, device=dev)
    kw.update(conjugate=conjugate, step=0.2 if conjugate else float(mcmc.samplers[1].step_size.reshape(())))
    return (scal, packed, mcmc.n_chains), kw


def compare_mixture(got, want):
    """Per-chain agreement of K10 with its plain version: means and lams (rtol
    1e-4, atol 1e-5), log_post (1e-4 relative), the accept count and, where
    stored, every allocation; returns (agreeing chains, max abs err)."""
    ok = torch.ones(got["means"].shape[0], dtype=torch.bool, device=got["means"].device)
    err = 0.0
    for name in ("means", "lams"):
        ok &= torch.isclose(got[name], want[name], rtol=1e-4, atol=1e-5).flatten(1).all(1)
        err = max(err, float(torch.max(torch.abs(got[name] - want[name]))))
    ok &= (torch.abs(got["log_post"] - want["log_post"]) <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0)).all(1)
    ok &= got["accept_total"] == want["accept_total"]
    if "z" in want:
        ok &= (got["z"] == want["z"]).flatten(1).all(1)
    return int(ok.sum()), err


def mixture_small_phase(dev):
    """K10 against its plain version on the same Philox bits, every value and
    every stored allocation of every chain: the random walk with a box and the
    conjugate means, K = 2 and 16, n = 200 and 3000 (past the JAX engine's
    2048-point resident limit), 256 chains, n_burn 4, n_keep 5, n_thin 2."""
    from openmcmc_tpu_torch.fused import mixture

    worst = 0.0
    for k, n, conjugate in ((2, 200, False), (2, 3000, True), (16, 200, True), (16, 3000, False)):
        rng = np.random.default_rng(k * n)
        y = np.linspace(-3.0, 3.0, k)[rng.integers(0, k, n)] + rng.normal(0.0, 0.5, n)
        domain = None if conjugate else (np.full(k, -20.0), np.full(k, 20.0))
        scal, data, kw = mixture.prepare(y, rng.uniform(0.2, 1.0, (n, k)), 0.0, 0.01, 2.0, 1.0,
                                         np.linspace(-1.0, 1.0, k), np.ones(k), domain=domain, device=dev)
        kw.update(conjugate=conjugate, step=0.3, n_burn=4, n_keep=5, n_thin=2, store_z=True)
        got = mixture.mixture_sweeps_kernel(SEED, scal, data, 256, **kw)
        want = mixture.mixture_sweeps_plain(SEED, scal, data, 256, **kw)
        torch.cuda.synchronize()
        agree, err = compare_mixture(got, want)
        same = equal_chains(got, want, ("means", "lams", "log_post", "accept_total", "z"))
        if agree != 256:
            raise AssertionError(f"mixture_small: K = {k}, n = {n}: only {agree} of 256 chains equal the plain version")
        worst = max(worst, err)
        log("mixture_small", f"K = {k}, n = {n}, {'conjugate' if conjugate else 'random walk with a box'}: all 256 "
            f"chains equal the plain version (every allocation, values rtol 1e-4), {same} bit for bit, max abs err "
            f"{err:.3g}; "
            f"{kw['threads']} threads per chain; accepts {int(got['accept_total'].sum())}")
    return worst


def sorted_draws(res):
    """The component means sorted per draw, and the lams in the same order
    (label switching, bench_all.py:694-700): (chains, n_iter, K) each."""
    means = res.store["means"][..., 0]
    order = torch.argsort(means, dim=-1)
    return {"means": torch.gather(means, -1, order), "lams": torch.gather(res.store["lams"][..., 0], -1, order)}


def mixture_flop(n, k, threads, n_sweeps):
    """K10's float32 operations per chain for ``n_sweeps`` sweeps."""
    return n_sweeps * (n * (K10_FLOP_PER_POINT_COMP * k + K10_FLOP_PER_POINT) + 4 * k * threads + K10_FLOP_PER_COMP * k)


def mixture_phase(dev, smi, kind):
    """One mixture cell: MCMC.run(engine="auto") with one K10 launch and no
    other, K10 against its plain version on a short run at full width, the
    sorted posterior means against the generic twin's, for ``mixture`` the run
    with Z stored and its log_post against Model.log_p, and the times."""
    from openmcmc_tpu_torch.fused import mixture

    mcmc = mixture_mcmc(dev, kind)
    engine = "fused_mixture" if kind == "mixture" else "fused_mixture_conjugate"
    n_chains, n_iter, k = mcmc.n_chains, mcmc.n_iter, mcmc.data["prior"].shape[1]
    n = mcmc.data["y"].shape[0]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only("mixture", 1):
        raise AssertionError(f"{kind}: engine {res.engine}, kernel launches {launches}")
    for name in ("means", "lams"):
        v = res.store[name]
        if tuple(v.shape) != (n_chains, n_iter, k, 1) or not bool(torch.all(torch.isfinite(v))) or v.device.type != DEVICE_TYPE:
            raise AssertionError(f"{kind}: store {name} {tuple(v.shape)} on {v.device}, or not finite")
    if tuple(res.log_post.shape) != (n_chains, n_iter) or not bool(torch.all(torch.isfinite(res.log_post))):
        raise AssertionError(f"{kind}: log_post {tuple(res.log_post.shape)} or not finite")
    stats = res.stats["means"]
    acc = None
    if kind == "mixture":
        if not bool(torch.all(stats["proposal"] == mcmc.n_burn + n_iter)):
            raise AssertionError(f"{kind}: proposal counts {stats['proposal'][:4]}")
        acc = float(res.acceptance["means"].mean())
    elif stats != {}:
        raise AssertionError(f"{kind}: conjugate means carry statistics {list(stats)}")
    fused = moments(sorted_draws(res), 8)
    ess = float(fused["means"][2].mean())
    log(kind, f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, means "
        f"{tuple(res.store['means'].shape)}, first run {wall:.3f} s"
        + ("" if acc is None else f"; acceptance {acc:.2f} %")
        + f"; sorted means {[round(float(v), 4) for v in fused['means'][0]]}, lams "
        f"{[round(float(v), 4) for v in fused['lams'][0]]}; mean ESS of the sorted means {ess:.1f} over "
        f"{n_chains * n_iter} draws")
    del res

    args, kw = mixture_inputs(mcmc, dev)
    short = dict(n_burn=1, n_keep=2, n_thin=1)
    got = mixture.mixture_sweeps_kernel(mcmc.seed, *args, **kw, **short)
    want, plain_ms = cuda_call_ms(lambda: mixture.mixture_sweeps_plain(mcmc.seed, *args, **kw, **short))
    agree, err = compare_mixture(got, want)
    same = equal_chains(got, want, ("means", "lams", "log_post", "accept_total"))
    del got, want
    torch.cuda.empty_cache()
    if agree < 0.999 * n_chains:
        raise AssertionError(f"{kind}: only {agree} of {n_chains} chains agree with the plain version")

    if kind == "mixture":
        zm = mixture_mcmc(dev, kind, store_names=None)
        reset_launches()
        res = zm.run(engine="auto")
        torch.cuda.synchronize()
        z = res.store["Z"]
        if res.engine != engine or read_launches() != only("mixture", 1) or tuple(z.shape) != (n_chains, n_iter, n, 1) \
                or z.dtype != torch.int32 or int(z.min()) < 0 or int(z.max()) >= k:
            raise AssertionError(f"{kind}: the default store set ran {res.engine}, Z {tuple(z.shape)} {z.dtype}")
        worst_lp = 0.0
        for c in (0, 1, n_chains - 1):
            for t in (0, n_iter // 2, n_iter - 1):
                state = dict(zm.data)
                state.update({name: res.store[name][c, t] for name in ("Z", "means", "lams")})
                want_lp = float(zm.model.log_p(state))
                rel = abs(float(res.log_post[c, t]) - want_lp) / max(1.0, abs(want_lp))
                worst_lp = max(worst_lp, rel)
        if not worst_lp <= 1e-4:
            raise AssertionError(f"{kind}: log_post differs from Model.log_p by {worst_lp:.3g} (relative)")
        log(kind, f"default store set: one K10 launch, Z {tuple(z.shape)} int32 ({z.numel() * 4 / 1e9:.2f} GB), "
            f"log_post within {worst_lp:.3g} (relative) of Model.log_p at the stored (Z, means, lams) of 3 chains x 3 "
            "draws (limit 1e-4)")
        del res, z, zm
        torch.cuda.empty_cache()

    large = kind == "mixture_large"
    gen = mixture_mcmc(dev, kind, n_chains=XL_GEN_CHAINS if large else X_GEN_CHAINS,
                       gen_burn=XL_GEN_BURN if large else X_GEN_BURN, gen_iter=XL_GEN_ITER if large else X_GEN_ITER)
    reset_launches()
    t0 = time.perf_counter()
    gen_res = gen.run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    if gen_res.engine != "generic" or any(read_launches().values()):
        raise AssertionError(f"{kind}: the generic twin ran {gen_res.engine} with kernel launches {read_launches()}")
    zs = moments_z(fused, moments(sorted_draws(gen_res), 8))
    del gen_res
    torch.cuda.empty_cache()
    if not zs < 5.0:
        raise AssertionError(f"{kind}: sorted posterior means off the generic run's by {zs:.2f} MC sd")
    log(kind, f"kernel and plain version agree on {agree} of {n_chains} chains at n_burn 1, n_iter 2 (rtol 1e-4), "
        f"{same} bit for bit, max abs err {err:.3g}; sorted means and lams within {zs:.2f} MC sd of the generic run's (limit 5; "
        f"generic run of {gen.n_chains} chains, {gen.n_burn} + {gen.n_iter} sweeps, {gen_wall:.3f} s)")

    run_hyp = dict(n_burn=mcmc.n_burn, n_keep=n_iter, n_thin=1)
    run_ms = cuda_ms(lambda: mixture.mixture_sweeps_kernel(mcmc.seed, *args, **kw, **run_hyp), 3)
    ms = cuda_ms(lambda: mixture.mixture_sweeps_kernel(mcmc.seed, *args, **kw, **short), 3)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = mcmc.run(engine="auto")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del res
    e2e = statistics.median(walls)

    def bound_of(n_sweeps, n_keep):
        n_bytes = 4 * ((3 + k) * n + 9 * k + n_chains * n_keep * (2 * k + 1) + n_chains)
        n_flop = n_chains * mixture_flop(n, k, kw["threads"], n_sweeps)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    run_bound = bound_of(mcmc.n_burn + n_iter, n_iter)
    bound_ms, bound_by, n_flop, n_bytes = bound_of(3, 2)
    log(kind, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of 3), "
        f"{1e3 * run_ms / (mcmc.n_burn + n_iter):.2f} us a sweep over {mcmc.n_burn + n_iter} sweeps, bound "
        f"{run_bound[0]:.4f} ms "
        f"({run_bound[1]}: {run_bound[2]:.3g} FLOP, {run_bound[3]:.3g} B), {run_ms / run_bound[0]:.1f}x; "
        f"MCMC.run end to end {1e3 * e2e:.3f} ms (median of 3)")
    log(kind, f"{smi}: at n_burn 1, n_iter 2: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms (the check's call), bound "
        f"{bound_ms:.5f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B)")
    log(kind, f"{smi}: ESS/s of the sorted means {ess / (run_ms / 1e3):.4g} on kernel time, {ess / e2e:.4g} end to end")
    out = {"launches": launches["mixture"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "run_ms": run_ms, "run_bound_ms": run_bound[0],
           "run_bound_by": run_bound[1], "run_e2e_ms": 1e3 * e2e, "ess_per_s": ess / (run_ms / 1e3)}
    if acc is not None:
        out["acceptance_pct"] = acc
    return out, launches["gamma_elem_draws"]


def rj_mcmc(dev, lik, n_chains=None, n_burn=0, n_iter=J_ITER, store_names=("n_basis",)):
    """bench_all.py's ``reversible_jump`` (Null likelihood) or
    ``reversible_jump_regression`` in the port: numpy seed 0, n_max 20, 50
    points on [-10, 10], four active knots to start, rho 8, beta ~ N(0, 4),
    omega ~ Gamma(3, 2), the regression's y from four knots with noise sd 0.1
    and tau_y ~ Gamma(2, 0.01); MCMC seed 0."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.basis import GaussianKernelBasis
    from openmcmc_tpu_torch.distributions import Gamma, Normal, NullDistribution, Poisson, Uniform
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, MixtureParameterMatrix, MixtureParameterVector, ScaledMatrix
    from openmcmc_tpu_torch.samplers import ManifoldMALA, NormalGamma, RandomWalkLoop, ReversibleJump

    g, rng = GaussianKernelBasis(), np.random.default_rng(0)
    X = np.sort(rng.uniform(-10, 10, (J_N, 1)), axis=0)
    if lik:
        th_true, beta_true = rng.uniform(-10, 10, (1, 4)), 2.0 * rng.normal(size=(4, 1))
        y = g.make(X, th_true, np.ones((1, 4)), 4).double().numpy() @ beta_true + 0.1 * rng.normal(size=(J_N, 1))
    k0 = 4
    theta = np.zeros((1, J_MAX)); theta[0, :k0] = rng.uniform(-10, 10, k0)
    omega = np.zeros((1, J_MAX)); omega[0, :k0] = 1.0
    beta = np.zeros((J_MAX, 1)); beta[:k0] = 1.0
    if not lik:
        y = rng.normal(size=(J_N, 1))
    state = {"X": X, "y": y, "n_basis": np.array([[k0]], dtype=np.int32), "theta": theta, "omega": omega,
             "beta": beta, "alloc_beta": np.zeros((J_MAX, 1), dtype=np.int32), "mu_beta": 0.0, "tau_beta": 0.25,
             "rho": 8.0, "a_omega": 3.0, "b_omega": 2.0, "P": st.Diagonal(torch.ones(J_N)), "tau_y": 100.0,
             "B": g.make(X, theta, omega, k0).numpy()}
    if lik:
        state.update(a_tau=2.0, b_tau=0.01)
    likelihood = Normal if lik else NullDistribution
    mdl = Model([
        likelihood("y", mean=LinearCombination(form={"beta": "B"}), precision=ScaledMatrix("P", "tau_y")),
        Normal("beta", mean=MixtureParameterVector("mu_beta", "alloc_beta"),
               precision=MixtureParameterMatrix("tau_beta", "alloc_beta"), n_active="n_basis"),
        Poisson("n_basis", rate="rho"),
        Uniform("theta", domain_response_lower=-10.0, domain_response_upper=10.0, n_active="n_basis"),
        Gamma("omega", shape="a_omega", rate="b_omega", n_active="n_basis"),
    ] + ([Gamma("tau_y", shape="a_tau", rate="b_tau")] if lik else []))
    walk = dict(state_update_function=g.move, vector_state_update_function=g.move_vec, active_count="n_basis")
    samplers = [
        ManifoldMALA("beta", mdl, step=0.5, active_count="n_basis"),
        RandomWalkLoop("theta", mdl, step=0.1, domain_limits=np.asarray([[-10.0, 10.0]]), updated_names=["theta", "B"],
                       **walk),
        RandomWalkLoop("omega", mdl, step=0.1, domain_limits=np.asarray([[0.5, 2.0]]), updated_names=["omega", "B"],
                       **walk),
        ReversibleJump("n_basis", mdl, associated_params=["theta", "omega"], n_max=J_MAX, state_birth_function=g.birth,
                       state_death_function=g.death,
                       matching_params={"variable": "beta", "matrix": "B", "scale": 1.0, "limits": [-10.0, 10.0]}),
    ] + ([NormalGamma("tau_y", mdl)] if lik else [])
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains or J_CHAINS, seed=0,
                store_names=list(store_names), device=dev)


def rj_inputs(mcmc, dev, n_burn, n_keep, stream):
    """K11's inputs for ``mcmc`` as the dispatcher feeds them (the model's
    constants, written out), over n_burn + n_keep sweeps."""
    from openmcmc_tpu_torch.fused import rj

    data, init = mcmc.data, mcmc.initial_chain_state
    lik = len(mcmc.samplers) == 5
    extra = dict(y=data["y"], a_tau=2.0, b_tau=0.01, tau0=100.0) if lik else {}
    return rj.prepare(mcmc.seed, data["X"], n_burn, n_keep, mcmc.n_chains, J_MAX, init["beta"], init["theta"],
                      init["omega"], float(init["n_basis"].reshape(())), rho=8.0, mu_beta=0.0, tau_beta=0.25,
                      a_omega=3.0, b_omega=2.0, stream_params=stream, device=dev, **extra)


def rj_small_phase(dev):
    """K11 against its plain version on the same Philox bits, every stored row of
    every chain: both variants at the CUDA tests' shapes (n_max 2 to 32, n_data 7
    to 1000, 37 to 2048 chains, n_thin 1 and 2, broadcast and per-chain warm
    initial rows), n_burn 2, n_keep 3, parameters streamed. The full-width cases
    (n_max 20, n_data 50, 2048 chains, warm counts spread over 1..20) give the
    kernel's active-size loops every count, k = n_max and k = 1 included."""
    from openmcmc_tpu_torch.fused import rj

    worst = 0.0
    for lik, p, n, chains, n_thin, warm in ((False, 2, 7, 37, 1, False), (False, 8, 50, 1000, 2, True),
                                            (False, 20, 200, 37, 1, False), (False, 32, 50, 37, 2, True),
                                            (True, 2, 50, 1000, 1, True), (True, 8, 7, 37, 2, False),
                                            (True, 20, 50, 37, 1, True), (True, 32, 200, 37, 2, False),
                                            (False, J_MAX, J_N, J_CHAINS, 1, True),
                                            (True, J_MAX, J_N, J_CHAINS, 1, True),
                                            (False, 32, 1000, 37, 2, True), (True, 32, 1000, 37, 1, True)):
        rng = np.random.default_rng(p * 1000 + n)
        X = np.sort(rng.uniform(-10, 10, n))
        y = np.sin(X) + 0.1 * rng.normal(size=n) if lik else None
        k0 = min(3, p)
        th, om, be = np.zeros(p), np.zeros(p), np.zeros(p)
        th[:k0], om[:k0], be[:k0] = rng.uniform(-10, 10, k0), 1.0, 1.0
        init = None
        if warm:
            k = rng.integers(1, p + 1, chains)
            act = np.arange(p)[None, :] < k[:, None]
            init = {"beta": rng.normal(size=(chains, p)) * act, "theta": rng.uniform(-10, 10, (chains, p)) * act,
                    "omega": rng.uniform(0.5, 2.0, (chains, p)) * act, "k": k, "tau": rng.uniform(0.5, 5.0, chains),
                    "counters": np.tile([[3.0], [7.0], [5.0], [1.0], [9.0], [9.0]], (1, chains))}
        data, rows, config = rj.prepare(SEED, X, 2, 3, chains, p, be, th, om, k0, rho=min(8.0, p / 2 + 0.5),
                                        stream_params=True, n_thin=n_thin, init=init, y=y, a_tau=2.0, b_tau=0.1,
                                        device=dev)
        got = rj.rj_sweeps_kernel(data, rows, chains, config=config)
        want = rj.rj_sweeps_plain(data, rows, chains, config=config)
        torch.cuda.synchronize()
        agree = int((got == want).flatten(1).all(1).sum())
        if agree != chains or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rj_small: lik {lik}, n_max {p}, n_data {n}: only {agree} of {chains} chains equal "
                                 "the plain version")
        worst = max(worst, float(torch.max(torch.abs(got - want))))
        log("rj_small", f"{'regression' if lik else 'Null'}, n_max {p}, n_data {n}, {chains} chains, n_thin {n_thin}"
            f"{', warm rows' if warm else ''}: all chains equal the plain version bit for bit (counts, counters, "
            f"accepts and values); births+deaths accepted {int(got[:, -1, 5].sum())}")
    return worst


def rj_marginal():
    """Mean and sd of the [1, J_MAX]-truncated Poisson(8)."""
    from scipy.stats import poisson

    ks = np.arange(1, J_MAX + 1)
    pmf = poisson.pmf(ks, 8.0)
    pmf = pmf / pmf.sum()
    mean = float((ks * pmf).sum())
    return mean, float(np.sqrt((ks * ks * pmf).sum() - mean * mean))


def rj_phase(dev, smi, lik):
    """One reversible-jump cell: MCMC.run(engine="auto") with one K11 launch and
    no other, J_RUNS times (the same draws each time; K11's time is the median
    of the runs', each from CUDA events around its launch; the first run also
    under the profiler, for the device's idle share), K11 against its plain
    version on a 5-sweep full-width streamed run, the statistical checks, the
    generic twin and the times."""
    from torch.profiler import ProfilerActivity, profile

    from openmcmc_tpu_torch.diagnostics import ess_per_param
    from openmcmc_tpu_torch.fused import rj

    kind = "rj_regression" if lik else "rj"
    mcmc = rj_mcmc(dev, lik, store_names=("n_basis", "tau_y") if lik else ("n_basis",))
    n_chains, n_iter = mcmc.n_chains, mcmc.n_iter
    if mcmc.n_burn != 0 or mcmc.n_thin != 1:
        raise AssertionError(f"{kind}: the bound reads every sweep's count from the store (0 burn-in, no thinning)")
    # the main path's runs: K11's device time from CUDA events around its launch,
    # the run's wall clock the end-to-end time; the first run also under a
    # device-only trace for the device's busy time (on the card such a trace has
    # lost the kernel's record of a repeated run, so no check depends on it)
    runs = []
    for rep in range(J_RUNS):
        reset_launches()
        torch.cuda.synchronize()
        tracing = profile(activities=[ProfilerActivity.CUDA]) if rep == 0 else contextlib.nullcontext()
        with launch_events(rj, "rj_sweeps") as marks, tracing as prof:
            t0 = time.perf_counter()
            out = mcmc.run(engine="auto")
            torch.cuda.synchronize()
            wall_r = time.perf_counter() - t0
        launches_r = read_launches()
        if out.engine != "fused_rj" or launches_r != only("rj", 1) or len(marks) != 1:
            raise AssertionError(f"{kind}: engine {out.engine}, kernel launches {launches_r}")
        runs.append(marks[0][0].elapsed_time(marks[0][1]))
        if rep == 0:
            res, launches, wall = out, launches_r, wall_r
            busy_us, prof_us, _ = device_times_us(prof, "rj_kernel")
        elif not torch.equal(out.store["n_basis"], res.store["n_basis"]):
            raise AssertionError(f"{kind}: main-path run {rep} drew other counts than the first")
        del out
    run_ms = statistics.median(runs)
    traced = (f"the profiler's K11 {prof_us / 1e3:.3f} ms of the first run, device busy {busy_us / 1e3:.3f} ms, "
              f"idle {100 * (1 - busy_us / (1e6 * wall)):.2f} %" if prof_us > 0 else
              "the profiler's trace of the first run lost K11's record: idle share not measured")
    nb = res.store["n_basis"]
    if tuple(nb.shape) != (n_chains, n_iter, 1, 1) or nb.dtype != torch.int32 or nb.device.type != DEVICE_TYPE:
        raise AssertionError(f"{kind}: store n_basis {tuple(nb.shape)} {nb.dtype} on {nb.device}")
    if int(nb.min()) < 1 or int(nb.max()) > J_MAX or not bool(torch.all(torch.isfinite(res.log_post))):
        raise AssertionError(f"{kind}: counts outside [1, {J_MAX}] or non-finite log_post")
    k = nb[..., 0, 0].to(torch.float32)
    k0 = float(mcmc.initial_chain_state["n_basis"].reshape(()))
    k_start = torch.cat([torch.full((n_chains, 1), k0, device=nb.device), k[:, :-1]], dim=1).to(torch.int64).cpu()
    run_accepts = sum(float(res.stats[name]["accept"].double().sum()) for name in ("beta", "theta", "omega"))
    acc = {name: round(float(v.double().mean()), 2) for name, v in res.acceptance.items()}
    ess = float(ess_per_param(k[..., None], chunk_size=8)[0])
    summary = {"acceptance_pct": acc, "ess_n_basis": ess}
    if lik:
        tau = res.store["tau_y"][..., 0, 0]
        kept = {"n_basis": k[:, JR_SKIP:], "tau_y": tau[:, JR_SKIP:]}
        fused = moments({name: v[..., None] for name, v in kept.items()}, 8)
        msg = (f"posterior means after {JR_SKIP} draws: n_basis {float(fused['n_basis'][0]):.4f}, tau_y "
               f"{float(fused['tau_y'][0]):.4f}")
    else:
        thin = k[:, ::10].double()
        exact_mean, exact_sd = rj_marginal()
        mean, sd = float(thin.mean()), float(thin.std())
        if not (abs(mean - exact_mean) < 0.25 and abs(sd - exact_sd) < 0.35):
            raise AssertionError(f"{kind}: count marginal mean {mean:.4f} sd {sd:.4f}, truncated Poisson(8) "
                                 f"{exact_mean:.4f} {exact_sd:.4f} (bounds 0.25, 0.35)")
        msg = (f"count marginal thinned by 10: mean {mean:.4f} (truncated Poisson(8) {exact_mean:.4f}, bound 0.25), "
               f"sd {sd:.4f} ({exact_sd:.4f}, bound 0.35)")
    log(kind, f"MCMC.run(engine='auto'): engine {res.engine}, kernel launches {launches}, n_basis "
        f"{tuple(nb.shape)} int32, first run {wall:.3f} s; {msg}; acceptance % {acc}; ESS of n_basis {ess:.1f} over "
        f"{n_chains * n_iter} draws; mean count at a sweep's start {float(k_start.double().mean()):.4f}; "
        f"{J_RUNS} runs, one K11 launch each, the same counts")
    del res, nb, k
    torch.cuda.empty_cache()

    data, rows, config = rj_inputs(mcmc, dev, 0, 5, True)
    got = rj.rj_sweeps_kernel(data, rows, n_chains, config=config)
    want, plain_ms = cuda_call_ms(lambda: rj.rj_sweeps_plain(data, rows, n_chains, config=config))
    agree = int((got == want).flatten(1).all(1).sum())
    err = float(torch.max(torch.abs(got - want)))
    if agree != n_chains:
        raise AssertionError(f"{kind}: only {agree} of {n_chains} chains equal the plain version on 5 sweeps")
    ms = cuda_ms(lambda: rj.rj_sweeps_kernel(data, rows, n_chains, config=config), 3)
    k5_start = torch.cat([torch.full((n_chains, 1), k0, device=got.device), got[:, :-1, 0]], dim=1)
    k5_start = k5_start.to(torch.int64).cpu()
    k5_accepts = float(got[:, -1, 2:5].double().sum())  # the counters start at zero
    k5_bytes = 4 * (data.numel() + rows.numel() + got.numel())
    del got, want
    per_k = rj_sweep_by_count(mcmc, dev, lik)

    if lik:
        sm = rj_mcmc(dev, lik, n_iter=20, store_names=("n_basis", "beta", "theta", "omega", "tau_y"))
        reset_launches()
        res = sm.run(engine="auto")
        torch.cuda.synchronize()
        if res.engine != "fused_rj" or read_launches() != only("rj", 1):
            raise AssertionError(f"{kind}: the streamed run ran {res.engine}")
        g = sm.samplers[3].state_birth_function.__self__
        worst_lp = 0.0
        for c in (0, 1, n_chains - 1):
            for t in (0, 10, 19):
                state = dict(sm.data)
                state.update({name: v[c, t] for name, v in res.store.items()})
                state["B"] = g.make(state["X"], state["theta"], state["omega"], state["n_basis"])
                want_lp = float(sm.model.log_p(state))
                worst_lp = max(worst_lp, abs(float(res.log_post[c, t]) - want_lp) / max(1.0, abs(want_lp)))
        if not worst_lp <= 1e-4:
            raise AssertionError(f"{kind}: log_post differs from Model.log_p by {worst_lp:.3g} (relative)")
        log(kind, f"streamed run (20 draws, beta/theta/omega/tau_y stored): one K11 launch, log_post within "
            f"{worst_lp:.3g} (relative) of Model.log_p at the stored draws of 3 chains x 3 draws (limit 1e-4)")
        del res, sm

    gen_note = rj_twin(dev, lik, fused if lik else (exact_mean, exact_sd))
    log(kind, f"kernel and plain version equal on all {agree} chains over 5 sweeps, parameters streamed (max abs err "
        f"{err:.3g}); {gen_note}")

    data, rows, config = rj_inputs(mcmc, dev, mcmc.n_burn, n_iter, False)  # the main run's sizes; no launch
    run_bytes = 4 * (data.numel() + rows.numel() + n_chains * n_iter * config.prm.n_rows)
    run_flop = rj_flop(k_start, J_MAX, J_N, lik, run_accepts)
    run_bound = (*bound(run_bytes, run_flop), run_flop, run_bytes)
    n_flop = rj_flop(k5_start, J_MAX, J_N, lik, k5_accepts)
    bound_ms, bound_by = bound(k5_bytes, n_flop)
    log(kind, f"{smi}: the main path's run: K11 {run_ms:.3f} ms of device time (CUDA events, median of {J_RUNS} "
        f"runs: {', '.join(f'{t:.3f}' for t in runs)}), bound {run_bound[0]:.4f} ms "
        f"({run_bound[1]}: {run_bound[2]:.4g} FLOP at the run's counts, {run_bound[3]:.4g} B), "
        f"{run_ms / run_bound[0]:.1f}x; MCMC.run end to end {1e3 * wall:.3f} ms (first run); {traced}")
    log(kind, f"{smi}: 5 sweeps: kernel {ms:.4f} ms (median of 3), plain {plain_ms:.1f} ms (the check's call), bound "
        f"{bound_ms:.5f} ms ({bound_by}: {n_flop:.4g} FLOP, {k5_bytes:.4g} B)")
    log(kind, f"{smi}: K11 per sweep from a fixed count k over {J_PER_K_SWEEPS} sweeps (CUDA events, median of 3): "
        + ", ".join(f"k {k}: {us:.1f} us" for k, us in per_k.items()))
    log(kind, f"{smi}: ESS/s of n_basis {ess / (run_ms / 1e3):.4g} on kernel time, {ess / wall:.4g} end to end")
    return {"launches": launches["rj"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "run_ms": run_ms, "run_ms_all": runs,
            "run_ms_profiler": prof_us / 1e3 if prof_us > 0 else None, "us_per_sweep_by_k": per_k,
            "run_bound_ms": run_bound[0], "run_bound_by": run_bound[1], "run_e2e_ms": 1e3 * wall,
            "ess_per_s": ess / (run_ms / 1e3), **summary}


def rj_sweep_by_count(mcmc, dev, lik):
    """K11's time per sweep (microseconds) on the cell's data and chains when
    every chain starts from count k (random active coefficients, knots and
    widths, padded entries 0), over J_PER_K_SWEEPS sweeps: the part of a sweep
    that does not grow with k against the part that does."""
    from openmcmc_tpu_torch.fused import rj

    data, n_chains, rng, out = mcmc.data, mcmc.n_chains, np.random.default_rng(1), {}
    extra = dict(y=data["y"], a_tau=2.0, b_tau=0.01) if lik else {}
    for k in J_PER_K:
        act = np.arange(J_MAX)[None, :] < k
        init = {"beta": rng.normal(size=(n_chains, J_MAX)) * act, "theta": rng.uniform(-10, 10, (n_chains, J_MAX)) * act,
                "omega": rng.uniform(0.5, 2.0, (n_chains, J_MAX)) * act, "k": np.full(n_chains, k),
                "tau": np.full(n_chains, 100.0)}
        zeros = np.zeros(J_MAX)
        inputs, rows, config = rj.prepare(mcmc.seed, data["X"], 0, J_PER_K_SWEEPS, n_chains, J_MAX, zeros, zeros,
                                          zeros, k, init=init, device=dev, **extra)
        ms = cuda_ms(lambda: rj.rj_sweeps_kernel(inputs, rows, n_chains, config=config), 3)
        out[k] = 1e3 * ms / J_PER_K_SWEEPS
    return out


def rj_twin(dev, lik, target):
    """The reversible-jump cell's generic twin (J_GEN_CHAINS chains, no kernel):
    its posterior means of n_basis and tau_y against the fused run's ``target``
    moments (rj_regression), or its count mean against the truncated Poisson(8)
    ``target`` (mean, sd) (rj), within 5 Monte Carlo sd."""
    from openmcmc_tpu_torch.diagnostics import ess_per_param

    kind = "rj_regression" if lik else "rj"
    gen = rj_mcmc(dev, lik, n_chains=J_GEN_CHAINS, n_burn=JR_GEN_BURN if lik else J_GEN_BURN,
                  n_iter=JR_GEN_ITER if lik else J_GEN_ITER, store_names=("n_basis", "tau_y") if lik else ("n_basis",))
    reset_launches()
    t0 = time.perf_counter()
    gen_res = gen.run()
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    if gen_res.engine != "generic" or any(read_launches().values()):
        raise AssertionError(f"{kind}: the generic twin ran {gen_res.engine} with kernel launches {read_launches()}")
    gk = gen_res.store["n_basis"][..., 0, 0].to(torch.float32)
    if lik:
        twin = moments({"n_basis": gk[..., None], "tau_y": gen_res.store["tau_y"][..., 0, :]}, 8)
        zs = moments_z(target, twin)
        what = "posterior means of n_basis and tau_y"
    else:
        exact_mean, exact_sd = target
        gmean, gess = float(gk.double().mean()), float(ess_per_param(gk[..., None], chunk_size=8)[0])
        zs = abs(gmean - exact_mean) / (exact_sd / np.sqrt(gess))
        what = f"count mean {gmean:.4f} (ESS {gess:.1f}) against the truncated Poisson(8)"
    del gen_res
    torch.cuda.empty_cache()
    if not zs < 5.0:
        raise AssertionError(f"{kind}: generic twin's {what} off by {zs:.2f} MC sd")
    return (f"generic twin ({gen.n_chains} chains, {gen.n_burn} + {gen.n_iter} sweeps, {gen_wall:.3f} s): {what} "
            f"within {zs:.2f} MC sd (limit 5)")


def main():
    smi = device_phase()
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(max_workers=1) as pool:
        building = pool.submit(build_phase)  # nvcc runs in processes of its own meanwhile
        mcmc, args, kw, hyp, want, k1_plain_ms = main_plain(dev)
        building.result()
    prng_res = prng_phase(dev)
    spectral_small_phase(dev)
    tri_res = tridiag_phase(dev, smi)
    launches, err, ess_b, fused_moments = main_path_phase(mcmc, want)
    del want
    k1_res = timing_phase(mcmc, args, kw, hyp, ess_b, k1_plain_ms, smi)
    del mcmc, args
    generic_launches = generic_phase(dev, fused_moments, tri_res, smi)
    resume_phase(dev, smi, fused_moments)
    trunc_draws = truncnorm_phase(dev)
    k4_err = gmrf_small_phase(dev)
    k4_trunc, k4_trunc_launches = truncated_phase(dev, smi)
    k4_long = thomas_long_phase(dev, smi, tri_res["thomas_long_twin"])
    k6 = linreg_phase(dev, smi)
    torch.cuda.empty_cache()
    k5, k5_store_launches, store_rows, store_v = linreg_wide_phase(dev, smi)
    torch.cuda.empty_cache()
    k7 = rw_phase(dev, smi, "rw")
    k7_box = rw_phase(dev, smi, "rw_box")
    k8 = mmala_phase(dev, smi, wide=False)
    torch.cuda.empty_cache()
    k9, k9_store_launches = mmala_phase(dev, smi, wide=True)
    torch.cuda.empty_cache()
    store_launches = {"fused": launches["spectral_store"], "linreg_wide": k5_store_launches,
                      "mmala_wide": k9_store_launches}
    store = store_phase(smi, store_rows, store_v, store_launches)
    del store_rows, store_v
    torch.cuda.empty_cache()
    gamma_elem = gamma_elem_phase(dev)
    k12 = gamma_phase(dev, smi)
    k10_small_err = mixture_small_phase(dev)
    k10, gamma_elem_launches = {}, 0
    for kind in ("mixture", "mixture_conjugate", "mixture_large"):
        k10[kind], n = mixture_phase(dev, smi, kind)
        gamma_elem_launches += n
    torch.cuda.empty_cache()
    k11_small_err = rj_small_phase(dev)
    k11 = {kind: rj_phase(dev, smi, lik) for kind, lik in (("rj", False), ("rj_regression", True))}
    k4 = {"route": "cuda", "source": "openmcmc_tpu_torch/csrc/gmrf_smoother.cu", "replaces": REPLACES["gmrf_smoother"]}
    k7_src = {"route": "cuda", "source": "openmcmc_tpu_torch/csrc/random_walk.cu", "replaces": REPLACES["random_walk"]}
    kernels = [
        {"name": "spectral_smoother", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/spectral_smoother.cu",
         "replaces": REPLACES["spectral_smoother"], "launches": launches["spectral_smoother"],
         "max_abs_err": err, **k1_res},
        {"name": "tridiag_canonical", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/tridiag_canonical.cu",
         "replaces": REPLACES["tridiag_canonical"], "launches": generic_launches["tridiag_canonical"], **tri_res,
         "launches_by_path": {"generic": generic_launches["tridiag_canonical"],
                              "thomas_long_twin": tri_res["thomas_long_twin"]["launches"]}},
        {"name": "gmrf_smoother_truncated", **k4, **k4_trunc,
         "max_abs_err": max(k4_trunc["max_abs_err"], k4_err)},
        {"name": "gmrf_smoother_thomas", **k4, **k4_long, "max_abs_err": max(k4_long["max_abs_err"], k4_err)},
        {"name": "linreg", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/linreg.cu",
         "replaces": REPLACES["linreg"], **k6},
        {"name": "spectral_linreg", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/spectral_linreg.cu",
         "replaces": REPLACES["spectral_linreg"], **k5},
        {"name": "random_walk", **k7_src, **k7},
        {"name": "random_walk_truncated", **k7_src, **k7_box},
        {"name": "mmala", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/mmala.cu", "replaces": REPLACES["mmala"],
         **k8},
        {"name": "spectral_mmala", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/spectral_mmala.cu",
         "replaces": REPLACES["spectral_mmala"], **k9},
        {"name": "spectral_store", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/spectral_store.cu",
         "replaces": REPLACES["spectral_store"], "also_replaces": "openmcmc_tpu/fused/spectral.py:755", **store},
    ] + [
        {"name": kind, "route": "cuda", "source": "openmcmc_tpu_torch/csrc/mixture.cu", "replaces": REPLACES["mixture"],
         **entry, "max_abs_err": max(entry["max_abs_err"], k10_small_err)} for kind, entry in k10.items()
    ] + [
        {"name": kind, "route": "cuda", "source": "openmcmc_tpu_torch/csrc/rj.cu", "replaces": REPLACES["rj"],
         **entry, "max_abs_err": max(entry["max_abs_err"], k11_small_err)} for kind, entry in k11.items()
    ] + [
        {"name": "gamma", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/gamma.cu", "replaces": REPLACES["gamma"],
         **k12},
    ]
    # prng_draws and truncnorm_draws are not launched by any path: their device
    # functions run inlined in the smoother kernels, and these kernels only
    # expose them for the check
    device_functions = [
        {"name": "prng_draws", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/prng_draws.cu",
         "replaces": REPLACES["prng_draws"], "launches": launches["prng_draws"],
         "inlined_in": "spectral_smoother, gmrf_smoother", **prng_res},
        {"name": "truncnorm_draws", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/prng_draws.cu",
         "replaces": REPLACES["truncnorm_draws"], "launches": k4_trunc_launches["truncnorm_draws"],
         "inlined_in": "gmrf_smoother", **trunc_draws},
        {"name": "gamma_elem_draws", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/prng_draws.cu",
         "replaces": REPLACES["gamma_elem_draws"], "launches": gamma_elem_launches,
         "inlined_in": "mixture", **gamma_elem},
    ]
    log("done", "every phase passed")
    print(smi)
    print(json.dumps({"kernels": kernels, "device_function_checks": device_functions}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
