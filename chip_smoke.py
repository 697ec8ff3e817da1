"""Smoke test of the PyTorch/CUDA port (openmcmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in openmcmc_tpu_torch/csrc,
holds each kernel against its plain PyTorch version on the card, and drives the
flagship smoother (bench.py's model: p = 100 RW1 GMRF, 8192 chains, 200 burn-in
and 500 stored sweeps) through both of the port's paths:

- ``MCMC(...).run(engine="auto")``, the fused path: one launch of the
  spectral-smoother kernel (K1), its draws held against the plain version;
- ``MCMC(...).run(engine="generic")``, the generic driver: one launch of the
  canonical tridiagonal kernel (K3) per sweep, its posterior means held against
  the fused run's within the Monte Carlo bound.

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
  ``fused_linreg_spectral``, the spectral linear-regression kernel (K5).

Then the Metropolis family, each cell through ``MCMC.run(engine="auto")`` with
one launch of its kernel, that kernel held against its plain version on a short
run at full width, and its posterior means held against a generic twin's (the
port's RandomWalk or ManifoldMALA, no kernel) and, where there is one, the
analytic posterior:

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
  ``fused_mmala_spectral``, the spectral mMALA kernel (K9).

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
    "mixture": "openmcmc_tpu/fused/mixture.py:107",
    "gamma_elem_draws": "openmcmc_tpu/fused/prng.py:218",
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
# their generic twins run fewer chains at the cell's depth
X_N, X_K, X_CHAINS, X_BURN, X_ITER, X_GEN_CHAINS = 200, 2, 4096, 500, 1000, 1024
XL_N, XL_K, XL_CHAINS, XL_BURN, XL_ITER, XL_GEN_CHAINS = 100_000, 16, 256, 50, 150, 64
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
        if "registers" in ln or "Compiling entry" in ln:
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


def _wrappers():
    from openmcmc_tpu_torch.fused import gmrf_smoother, linreg, mmala, prng, random_walk, spectral
    from openmcmc_tpu_torch.linalg import tridiag

    from openmcmc_tpu_torch.fused import mixture

    return {"spectral_smoother": spectral.smoother_sweeps_kernel, "prng_draws": prng.draws,
            "tridiag_canonical": tridiag.sample_canonical_tridiag_kernel,
            "gmrf_smoother": gmrf_smoother.gmrf_smoother_kernel, "truncnorm_draws": prng.truncnorm_draws,
            "linreg": linreg.linreg_sweeps_kernel, "spectral_linreg": spectral.spectral_linreg_sweeps_kernel,
            "random_walk": random_walk.rw_sweeps_kernel, "mmala": mmala.mmala_sweeps_kernel,
            "spectral_mmala": spectral.spectral_mmala_sweeps_kernel, "mixture": mixture.mixture_sweeps_kernel,
            "gamma_elem_draws": prng.gamma_elem_draws}


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


def only(name, count):
    """The launch counts of a path that launches kernel ``name`` ``count`` times and no other."""
    return {k: (count if k == name else 0) for k in _wrappers()}


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
    """MCMC.run(engine="auto") with the counts at 0 around it, one K1 launch, its
    store against the plain version's run, its posterior moments."""
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != "fused_smoother_spectral":
        raise AssertionError(f"main path dispatched to {res.engine}")
    if launches != only("spectral_smoother", 1):
        raise AssertionError(f"fused path: kernel launches {launches}, not one spectral_smoother launch")
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
    """K1's time, the bound and MCMC.run end to end; ``plain_ms`` is the main
    path's check call of the plain version."""
    from openmcmc_tpu_torch.fused import spectral

    def kernel():
        return spectral.smoother_sweeps_kernel(SEED, *args, **kw, **hyp)

    ms = cuda_ms(kernel, 5)
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
    log("time", f"{smi}: spectral kernel {ms:.3f} ms (median of 5), plain {plain_ms:.1f} ms (the check's call), "
        f"bound {bound_ms:.3f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B), "
        f"MCMC.run end to end {1e3 * e2e:.3f} ms (median of 5)")
    log("time", f"{smi}: ESS/s {ess_b / (ms / 1e3):.4g} on kernel time, {ess_b / e2e:.4g} end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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
    the main path's shape and at a ragged one; then its draw's moments."""
    from openmcmc_tpu_torch.linalg import tridiag

    worst = 0.0
    for n_chains, p in ((N_CHAINS, N_TIME), (1000, 4099)):
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
        log("tridiag", f"({n_chains}, {p}): all values agree with the plain version (rtol 1e-4, atol 1e-5), "
            f"max abs err {err:.3g}")

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

    def kernel():
        return tridiag.sample_canonical_tridiag(SEED, 5, a, c, b)

    def plain():
        return tridiag.sample_canonical_tridiag_plain(SEED, 5, a, c, b)

    kernel()
    torch.cuda.synchronize()
    ms = cuda_ms(kernel, 25)
    plain_ms = cuda_ms(plain, 5)
    bound_ms, bound_by = bound(16 * N_CHAINS * N_TIME, K3_FLOP_PER_ELEM * N_CHAINS * N_TIME)
    log("tridiag", f"{smi}: at ({N_CHAINS}, {N_TIME}) the wrapper (layout transposes and kernel) takes {ms:.4f} ms "
        f"(median of 25), plain {plain_ms:.3f} ms (median of 5), bound {1e3 * bound_ms:.2f} us ({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


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


def device_times_us(prof):
    """Device busy time, K3's device time (microseconds) and the five entries with
    the most device time, from the key averages of a device-only trace (kernels,
    copies and fills, so no time is counted twice)."""
    def self_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)

    events = [e for e in prof.key_averages() if self_us(e) > 0]
    top = sorted(events, key=self_us, reverse=True)[:5]
    return (sum(self_us(e) for e in events), sum(self_us(e) for e in events if "tridiag_canonical" in e.key),
            [(e.key[:60], e.count, round(self_us(e) / 1e3, 3)) for e in top])


def generic_phase(dev, fused_moments, k3_ms, smi):
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
        f"runs); K3 {n_sweeps} x {k3_ms:.4f} ms = {n_sweeps * k3_ms:.3f} ms "
        f"({100 * n_sweeps * k3_ms / (1e3 * e2e):.1f} % of the run); mean ESS of b {ess_b:.1f}; "
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
            name = f"{'truncated' if truncated else 'thomas'} ({chains}, {p})"
            if agree != chains:
                raise AssertionError(f"gmrf_smoother kernel, {name}: {chains - agree} of {chains} chains differ")
            if truncated and not bool(torch.all((got["b"] >= kw["lo"]) & (got["b"] <= kw["hi"]))):
                raise AssertionError(f"gmrf_smoother kernel, {name}: a draw left the box")
            worst = max(worst, err)
            log("gmrf", f"{name}, n_burn=3 n_iter=5 n_thin=2: all values agree with the plain version "
                f"(rtol 1e-4), max abs err {err:.3g}")
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
    log(tag, f"{smi}: gmrf_smoother kernel {full_ms:.3f} ms for the whole run (median of {reps}), bound "
        f"{full_bound[0]:.4f} ms ({full_bound[1]}: {full_bound[2]:.3g} FLOP, {full_bound[3]:.3g} B); MCMC.run end "
        f"to end {1e3 * e2e:.3f} ms (median of {reps})")
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
    log(tag, f"{agree} of {T_CHAINS} chains agree with the plain version (rtol 1e-4), max abs err {err:.3g}; "
        f"means of b, lambda, tau within {z:.2f} MC sd of the generic run's (limit 5; generic run {gen_wall:.3f} s); "
        f"mean ESS of b {ess_b:.1f} over {T_CHAINS * T_ITER} draws")
    entry = k4_times(smi, tag, mcmc, args, kw, hyp, K4_FLOP_PER_TRUNC_ROW, ess_b, plain_ms, reps=3)
    return {"launches": launches["gmrf_smoother"], "max_abs_err": err, **entry}, launches


def thomas_long_phase(dev, smi):
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
    del got, want
    if agree != L_CHAINS:
        raise AssertionError(f"{tag}: {L_CHAINS - agree} of {L_CHAINS} chains differ from the plain version")
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
    log(tag, f"kernel and plain version agree on all {L_CHAINS} chains at p = {L_P}, n_burn 2, n_iter 3 (rtol "
        f"1e-4), max abs err {err:.3g}; means of b, lambda, tau within {z:.2f} MC sd of the generic (K3) run's "
        f"(limit 5; generic run of {L_GEN_BURN} + {L_GEN_ITER} sweeps {gen_wall:.3f} s); mean ESS of b {ess_b:.1f} over "
        f"{L_CHAINS * L_ITER} draws")
    entry = k4_times(smi, tag, mcmc, args, kw, hyp, K4_FLOP_PER_THOMAS_ROW, ess_b, plain_ms, reps=1,
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


def linreg_cell(tag, mcmc, engine, kernel):
    """One linear-regression cell's run: MCMC.run(engine="auto") with the counts
    at 0 around it, one launch of ``kernel`` and no other, the store's shape and
    finiteness."""
    n_chains, n_iter, p = mcmc.n_chains, mcmc.n_iter, mcmc.data["X"].shape[1]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only(kernel, 1):
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


def linreg_checks(tag, mcmc, res, kernel_fn, plain_fn, args, kw, short, gen_mcmc, chunk_size):
    """The kernel against its plain version on a short run at full width
    (>= 99.9 % of chains agree), and the fused run's posterior means of beta,
    tau and log lambda against the generic twin's (within 5 MC sd), which
    launches no kernel (the dense NormalNormal step)."""
    fused = linreg_moments(res, chunk_size)
    ess_beta = float(fused["beta"][2].mean())
    del res
    torch.cuda.empty_cache()
    got = kernel_fn(mcmc.seed, *args, **kw, **short)
    want, plain_ms = cuda_call_ms(lambda: plain_fn(mcmc.seed, *args, **kw, **short))
    agree, err = compare(got, want, draw="beta")
    del got, want
    n_chains = mcmc.n_chains
    if agree < 0.999 * n_chains:
        raise AssertionError(f"{tag}: only {agree} of {n_chains} chains agree with the plain version")
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
        f"{short['n_keep']} (rtol 1e-4), max abs err {err:.3g}; means of beta, tau, log lambda within {z:.2f} MC sd "
        f"of the generic run's (limit 5; generic run of {gen_mcmc.n_chains} chains, {gen_mcmc.n_burn} + "
        f"{gen_mcmc.n_iter} sweeps, {gen_wall:.3f} s); mean ESS of beta {ess_beta:.1f} over "
        f"{n_chains * mcmc.n_iter} draws")
    return err, plain_ms, ess_beta


def linreg_times(smi, tag, mcmc, kernel_fn, args, kw, run_hyp, short, flop_fn, n_in, ess_beta, plain_ms, reps):
    """The kernel's time on the whole run and on the plain version's short run
    (CUDA events, median of ``reps``), MCMC.run end to end, the bounds."""
    n_chains, p = mcmc.n_chains, mcmc.data["X"].shape[1]

    def bound_of(h):
        n_sweeps, n_keep = h["n_burn"] + h["n_keep"] * h["n_thin"], h["n_keep"]
        n_bytes = 4 * (n_in + 2 * n_chains + n_chains * n_keep * (p + 3))
        n_flop = n_chains * flop_fn(n_sweeps, n_keep)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    run_ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, **run_hyp), reps)
    # the same sweeps with one stored draw: the rest of run_ms is the stores' share
    n_sweeps = run_hyp["n_burn"] + run_hyp["n_keep"] * run_hyp["n_thin"]
    sweeps_ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, n_burn=n_sweeps - 1, n_keep=1, n_thin=1), reps)
    ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, **short), reps)
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
    log(tag, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of {reps}), bound {run_bound[0]:.4f} ms "
        f"({run_bound[1]}: {run_bound[2]:.3g} FLOP, {run_bound[3]:.3g} B); MCMC.run end to end {1e3 * e2e:.3f} ms "
        f"(median of {reps}); the same {n_sweeps} sweeps with one stored draw {sweeps_ms:.4f} ms")
    log(tag, f"{smi}: at n_burn {short['n_burn']}, n_iter {short['n_keep']}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
        f"(the check's call), bound {bound_ms:.5f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B)")
    log(tag, f"{smi}: ESS/s of beta {ess_beta / (run_ms / 1e3):.4g} on kernel time, {ess_beta / e2e:.4g} end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "run_ms": run_ms, "run_bound_ms": run_bound[0], "run_bound_by": run_bound[1], "run_e2e_ms": 1e3 * e2e}


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
    err, plain_ms, ess_beta = linreg_checks(tag, mcmc, res, linreg.linreg_sweeps_kernel,
                                            linreg.linreg_sweeps_plain, args, kw, short, gen, chunk_size=8)

    def flop(n_sweeps, n_keep):
        return n_sweeps * k6_flop_per_sweep(p) + n_keep * K6_FLOP_PER_STORE

    entry = linreg_times(smi, tag, mcmc, linreg.linreg_sweeps_kernel, args, kw,
                         dict(n_burn=R_BURN, n_keep=R_ITER, n_thin=1), short, flop, p * p + 3 * p + 3, ess_beta,
                         plain_ms, reps=5)
    return {"launches": launches["linreg"], "max_abs_err": err, **entry}


def linreg_wide_phase(dev, smi):
    """p = 256: one K5 launch, K5 against its plain version on 2 + 3 sweeps at
    full width, posterior means against a generic run of 256 chains, times."""
    from openmcmc_tpu_torch.fused import spectral

    tag = "linreg_wide"
    X, y = wide_data()
    mcmc = linreg_mcmc(dev, X, y, W_CHAINS, W_BURN, W_ITER, W_SEED, 1.0, 1.0)
    res, launches = linreg_cell(tag, mcmc, "fused_linreg_spectral", "spectral_linreg")
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
    err, plain_ms, ess_beta = linreg_checks(tag, mcmc, res, spectral.spectral_linreg_sweeps_kernel,
                                            spectral.spectral_linreg_sweeps_plain, args, kw, short, gen,
                                            chunk_size=32)

    def flop(n_sweeps, n_keep):
        return n_sweeps * (K5_FLOP_PER_COORD * W_P + K5_FLOP_PER_SWEEP) + n_keep * (2 * W_P * W_P + K5_FLOP_PER_STORE)

    entry = linreg_times(smi, tag, mcmc, spectral.spectral_linreg_sweeps_kernel, args, kw,
                         dict(n_burn=W_BURN, n_keep=W_ITER, n_thin=1), short, flop, W_P * W_P + 3 * W_P, ess_beta,
                         plain_ms, reps=3)
    return {"launches": launches["spectral_linreg"], "max_abs_err": err, **entry}


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


def mh_cell(tag, mcmc, engine, kernel, name):
    """One Metropolis cell's run: MCMC.run(engine="auto") with the counts at 0
    around it, one launch of ``kernel`` and no other, the store's shape and
    finiteness, the statistics' shapes."""
    n_chains, n_iter, p = mcmc.n_chains, mcmc.n_iter, mcmc.initial_chain_state[name].shape[0]
    reset_launches()
    t0 = time.perf_counter()
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if res.engine != engine or launches != only(kernel, 1):
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
              keep_from=0):
    """The kernel against its plain version on a short run at full width
    (>= 99.9 % of chains agree), the fused run's posterior means against the
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
    del got, want
    n_chains = mcmc.n_chains
    if agree < 0.999 * n_chains:
        raise AssertionError(f"{tag}: only {agree} of {n_chains} chains agree with the plain version")
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
        f"{short['n_keep']} (rtol 1e-4, every accept decision), max abs err {err:.3g}; means of {name} within "
        f"{z:.2f} MC sd of the generic run's (limit 5; generic run of {gen_mcmc.n_chains} chains, {gen_mcmc.n_burn} + "
        f"{gen_mcmc.n_iter} sweeps, {gen_wall:.3f} s, acceptance {gen_acc:.2f} %)"
        + ("" if exact_z is None else f" and within {exact_z:.2f} MC sd of the analytic posterior")
        + f"; mean ESS of {name} {ess:.1f} over {n_chains * mcmc.n_iter} draws")
    return err, plain_ms, ess


def mh_times(smi, tag, mcmc, kernel_fn, args, kw, run_hyp, short, flop_fn, n_in, p, ess, acc, plain_ms, reps):
    """The kernel's time on the whole run, on the same sweeps with one stored
    draw and on the plain version's short run (CUDA events, median of ``reps``),
    MCMC.run end to end, the bounds."""
    n_chains = mcmc.n_chains

    def bound_of(h):
        n_sweeps, n_keep = h["n_burn"] + h["n_keep"] * h["n_thin"], h["n_keep"]
        n_bytes = 4 * (n_in + n_chains * n_keep * (p + 2) + 2 * n_chains)
        n_flop = n_chains * flop_fn(n_sweeps, n_keep)
        return (*bound(n_bytes, n_flop), n_flop, n_bytes)

    run_ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, **run_hyp), reps)
    n_sweeps = run_hyp["n_burn"] + run_hyp["n_keep"] * run_hyp["n_thin"]
    sweeps_ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, n_burn=n_sweeps - 1, n_keep=1, n_thin=1), reps)
    ms = cuda_ms(lambda: kernel_fn(mcmc.seed, *args, **kw, **short), reps)
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
    log(tag, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of {reps}), bound {run_bound[0]:.4f} ms "
        f"({run_bound[1]}: {run_bound[2]:.3g} FLOP, {run_bound[3]:.3g} B); MCMC.run end to end {1e3 * e2e:.3f} ms "
        f"(median of {reps}); the same {n_sweeps} sweeps with one stored draw {sweeps_ms:.4f} ms")
    log(tag, f"{smi}: at n_burn {short['n_burn']}, n_iter {short['n_keep']}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms "
        f"(the check's call), bound {bound_ms:.5f} ms ({bound_by}: {n_flop:.3g} FLOP, {n_bytes:.3g} B)")
    log(tag, f"{smi}: acceptance {acc:.2f} %; ESS/s {ess / (run_ms / 1e3):.4g} on kernel time, {ess / e2e:.4g} "
        "end to end")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "run_ms": run_ms, "run_bound_ms": run_bound[0], "run_bound_by": run_bound[1], "run_e2e_ms": 1e3 * e2e}


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
    err, plain_ms, ess = mh_checks(kind, mcmc, res, "h", rw.rw_sweeps_kernel, rw.rw_sweeps_plain, (scal, mcmc.n_chains),
                                   kw, short, gen, "h", chunk, exact=exact, keep_from=200)
    per_coord = K7_FLOP_PER_TRUNC_COORD if box is not None else K7_FLOP_PER_COORD

    def flop(n_sweeps, n_keep):
        return n_sweeps * (per_coord * p + K7_FLOP_PER_SWEEP)

    entry = mh_times(smi, kind, mcmc, rw.rw_sweeps_kernel, (scal, mcmc.n_chains), kw,
                     dict(n_burn=mcmc.n_burn, n_keep=mcmc.n_iter, n_thin=1), short, flop, scal.numel(), p, ess, acc,
                     plain_ms, reps=3)
    return {"launches": launches["random_walk"], "max_abs_err": err, "acceptance_pct": acc, **entry}


def st_diag(value, p):
    """The (p,) diagonal of a constant diagonal precision entry, on the host."""
    from openmcmc_tpu_torch.linalg import structured as st

    d = st.diag(st.as_structured(value)).detach().cpu().double().numpy().reshape(-1)
    return np.broadcast_to(d, (p,)).copy()


def mmala_phase(dev, smi, wide):
    """``mmala`` (K8, p = 5) or ``mmala_wide`` (K9, p = 256): one launch, the
    kernel against its plain version, posterior means against the generic twin's
    and the analytic posterior c = A^-1 v."""
    from openmcmc_tpu_torch.fused import mmala, spectral

    tag = "mmala_wide" if wide else "mmala"
    mcmc = mmala_mcmc(dev, wide)
    engine, kernel = ("fused_mmala_spectral", "spectral_mmala") if wide else ("fused_mmala", "mmala")
    res, launches, acc = mh_cell(tag, mcmc, engine, kernel, "beta")
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
    err, plain_ms, ess = mh_checks(tag, mcmc, res, "beta", kernel_fn, plain_fn, args, kw, short, gen, "beta", chunk,
                                   exact=mmala_posterior(wide))
    entry = mh_times(smi, tag, mcmc, kernel_fn, args, kw, dict(n_burn=mcmc.n_burn, n_keep=mcmc.n_iter, n_thin=1),
                     short, flop, n_in, p, ess, acc, plain_ms, reps=3)
    return {"launches": launches[kernel], "max_abs_err": err, "acceptance_pct": acc, **entry}


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


def mixture_mcmc(dev, kind, n_chains=None, store_names=("means", "lams")):
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
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains or chains, seed=0,
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
        if agree != 256:
            raise AssertionError(f"mixture_small: K = {k}, n = {n}: only {agree} of 256 chains equal the plain version")
        worst = max(worst, err)
        log("mixture_small", f"K = {k}, n = {n}, {'conjugate' if conjugate else 'random walk with a box'}: all 256 "
            f"chains equal the plain version (every allocation, values rtol 1e-4), max abs err {err:.3g}; "
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

    gen = mixture_mcmc(dev, kind, n_chains=X_GEN_CHAINS if kind != "mixture_large" else XL_GEN_CHAINS)
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
        f"max abs err {err:.3g}; sorted means and lams within {zs:.2f} MC sd of the generic run's (limit 5; "
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
    log(kind, f"{smi}: kernel {run_ms:.4f} ms for the whole run (median of 3), bound {run_bound[0]:.4f} ms "
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
    generic_launches = generic_phase(dev, fused_moments, tri_res["ms"], smi)
    trunc_draws = truncnorm_phase(dev)
    k4_err = gmrf_small_phase(dev)
    k4_trunc, k4_trunc_launches = truncated_phase(dev, smi)
    k4_long = thomas_long_phase(dev, smi)
    k6 = linreg_phase(dev, smi)
    torch.cuda.empty_cache()
    k5 = linreg_wide_phase(dev, smi)
    torch.cuda.empty_cache()
    k7 = rw_phase(dev, smi, "rw")
    k7_box = rw_phase(dev, smi, "rw_box")
    k8 = mmala_phase(dev, smi, wide=False)
    torch.cuda.empty_cache()
    k9 = mmala_phase(dev, smi, wide=True)
    torch.cuda.empty_cache()
    gamma_elem = gamma_elem_phase(dev)
    k10_small_err = mixture_small_phase(dev)
    k10, gamma_elem_launches = {}, 0
    for kind in ("mixture", "mixture_conjugate", "mixture_large"):
        k10[kind], n = mixture_phase(dev, smi, kind)
        gamma_elem_launches += n
    k4 = {"route": "cuda", "source": "openmcmc_tpu_torch/csrc/gmrf_smoother.cu", "replaces": REPLACES["gmrf_smoother"]}
    k7_src = {"route": "cuda", "source": "openmcmc_tpu_torch/csrc/random_walk.cu", "replaces": REPLACES["random_walk"]}
    kernels = [
        {"name": "spectral_smoother", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/spectral_smoother.cu",
         "replaces": REPLACES["spectral_smoother"], "launches": launches["spectral_smoother"],
         "max_abs_err": err, **k1_res},
        {"name": "tridiag_canonical", "route": "cuda", "source": "openmcmc_tpu_torch/csrc/tridiag_canonical.cu",
         "replaces": REPLACES["tridiag_canonical"], "launches": generic_launches["tridiag_canonical"], **tri_res},
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
    ] + [
        {"name": kind, "route": "cuda", "source": "openmcmc_tpu_torch/csrc/mixture.cu", "replaces": REPLACES["mixture"],
         **entry, "max_abs_err": max(entry["max_abs_err"], k10_small_err)} for kind, entry in k10.items()
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
