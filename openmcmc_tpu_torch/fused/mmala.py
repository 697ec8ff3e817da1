"""Constant-metric manifold MALA, the whole run in one launch, p <= 16 (kernel K8).

Port of ``openmcmc_tpu/fused/mmala.py`` (``run_fused_mmala`` :186, kernel
``_make_kernel`` :49). Model, with tau and lam fixed:

    y ~ N(X beta, (tau diag(ptau))^-1),   beta ~ N(mu0, (lam diag(plam))^-1),

whose negative Hessian A = tau X'PX + lam diag(plam) is constant, so the mMALA
step precomputes once (on the host, in float64):

    grad log pi(b) = v - A b,   v = tau X'Py + lam plam mu0,   c = A^-1 v,
    proposal N(mu(b), s^2 A^-1),  mu(b) = (1 - s^2/2) b + (s^2/2) c,  L = chol(A),
    log pi(b) = const - 1/2 (b'Ab + yPy) + b'v,  yPy = tau y'Py + lam mu0'Plam mu0.

A sweep per chain: p normals, the draw mu + s L^-T z by back substitution, the
target at the proposal, both proposal densities, the accept; with ``adapt`` a
per-chain log step nudged toward the target acceptance during burn-in.

:func:`mmala_sweeps` launches ``csrc/mmala.cu`` for a CUDA ``scal`` and takes
:func:`mmala_sweeps_plain` for a CPU one; both add every sum term by term in
the JAX kernel's order (the target's -1/2 (b'Ab + yPy) + b'v cancels heavily).
Bits as in :mod:`openmcmc_tpu_torch.fused.prng`: site 0 holds the p normals,
site 1 the accept uniform.

Not ported, because they exist for the TPU only: ``linalg/smallmat.py`` (the
host preparation runs in float64 numpy instead of the JAX package's float32
device arithmetic), the BLOCK_B lane blocks, the out_rows padding and the store
DMAs. Resume (``init=``) is not ported yet (ROADMAP.md queue 1: operations).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import store_index
from openmcmc_tpu_torch.utils import profiling

MAX_P = 16


def _f64(v) -> np.ndarray:
    return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)


def prepare(X, y, tau=1.0, lam=1.0, ptau_diag=None, plam_diag=None, mu0=None, beta0=None):
    """Host preparation in float64: A, L = chol(A), v, c = A^-1 v, beta0, yPy and
    the log-determinants, as the JAX package's ``run_fused_mmala`` computes them
    (there in float32). Returns the float32 ``scal`` block [A | L | v | c | beta0 |
    yPy | logdet(tau P) | logdet(lam Plam) | log|L|] (2 p^2 + 3 p + 4 entries),
    and ``n_obs`` and ``p``."""
    X = _f64(X)
    y = _f64(y).reshape(-1)
    n_obs, p = X.shape
    ptau = np.ones(n_obs) if ptau_diag is None else _f64(ptau_diag).reshape(-1)
    plam = np.ones(p) if plam_diag is None else _f64(plam_diag).reshape(-1)
    mu0 = np.zeros(p) if mu0 is None else _f64(mu0).reshape(-1)
    beta0 = np.zeros(p) if beta0 is None else _f64(beta0).reshape(-1)
    XtP = X.T * ptau[None, :]
    A = tau * (XtP @ X) + lam * np.diag(plam)
    v = tau * (XtP @ y) + lam * plam * mu0
    L = np.linalg.cholesky(A)
    c = np.linalg.solve(A, v)
    yPy = tau * np.sum(y * ptau * y) + lam * np.sum(mu0 * plam * mu0)
    logdet_tauP = n_obs * math.log(tau) + np.sum(np.log(ptau))
    logdet_lamPlam = p * math.log(lam) + np.sum(np.log(plam))
    logdetL = np.sum(np.log(np.diag(L)))
    scal = np.concatenate([A.reshape(-1), L.reshape(-1), v, c, beta0, [yPy, logdet_tauP, logdet_lamPlam, logdetL]])
    return {"scal": scal.astype(np.float32), "n_obs": n_obs, "p": p}


def step_constants(p: int, step: float) -> dict:
    """The float32 constants of a fixed (not adapted) step, folded on the host in
    float64 as the JAX kernel folds them: s, s^2, 1 - s^2/2, s^2/2 and
    p/2 (log 2 pi + log s^2)."""
    s2 = step * step
    return {"step": step, "s2": s2, "c_keep": 1.0 - 0.5 * s2, "c_pull": 0.5 * s2,
            "c_norm": 0.5 * p * (prng.LOG_2PI + math.log(s2))}


@profiling.traced("kernel.mmala")
def mmala_sweeps_plain(seed, scal, n_chains, *, p, n_obs, step, adapt, target, rate, n_burn, n_keep, n_thin=1,
                       bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``scal`` is :func:`prepare`'s float32 block on the run's device; ``step``
    the initial (or fixed) step; ``n_burn`` counts burn-in SWEEPS and ``n_keep``
    stored draws, each after ``n_thin`` sweeps. Draws come from Philox unless
    ``bit_source(sweep, site, shape)`` supplies them (CPU tensors only). Returns
    ``beta`` (chains, n_keep, p), ``log_post``/``accept`` (chains, n_keep) and
    ``accept_total``/``log_step`` (chains,)."""
    device = scal.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    f32 = dict(dtype=torch.float32, device=device)
    sc = scal.to(**f32)
    A = sc[: p * p].reshape(p, p)
    L = sc[p * p: 2 * p * p].reshape(p, p)
    v, c, b0 = (sc[2 * p * p + k * p: 2 * p * p + (k + 1) * p].unbind(0) for k in range(3))
    yPy, logdet_tauP, logdet_lamPlam, logdetL = sc[2 * p * p + 3 * p:].unbind(0)
    lik_const = 0.5 * (logdet_tauP - n_obs * prng.LOG_2PI)
    pri_const = 0.5 * (logdet_lamPlam - p * prng.LOG_2PI)
    fixed = step_constants(p, step)

    def log_target(b):
        quad = torch.zeros_like(b[0])
        lin = torch.zeros_like(b[0])
        for i in range(p):
            lin = lin + v[i] * b[i]
            for j in range(p):
                quad = quad + A[i, j] * b[i] * b[j]
        return lik_const + pri_const - 0.5 * (quad + yPy) + lin

    def prop_logq(b_to, mu, c_norm, s2):
        ssq = torch.zeros_like(b_to[0])
        for j in range(p):
            w = torch.zeros_like(b_to[0])
            for i in range(j, p):
                w = w + L[i, j] * (b_to[i] - mu[i])
            ssq = ssq + w * w
        return logdetL - c_norm - 0.5 * ssq / s2

    b = [torch.zeros(n_chains, **f32) + b0[i] for i in range(p)]
    lp = log_target(b)
    acc = torch.zeros(n_chains, **f32)
    log_step = torch.full((n_chains,), math.log(step), **f32)
    out_b = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("log_post", "accept")}
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, [p, 1], device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate((p, 1))]
        if adapt:
            step_v = torch.exp(log_step)
            s2 = step_v * step_v
            c_keep, c_pull = 1.0 - 0.5 * s2, 0.5 * s2
            c_norm = 0.5 * p * (prng.LOG_2PI + torch.log(s2))
        else:
            step_v, s2, c_keep, c_pull, c_norm = (fixed[k] for k in ("step", "s2", "c_keep", "c_pull", "c_norm"))
        z = prng.normal_icdf((n_chains, p), lambda shape: sites[0]).unbind(1)
        mu_cur = [c_keep * b[i] + c_pull * c[i] for i in range(p)]
        eps = [None] * p
        for i in range(p - 1, -1, -1):
            w = z[i]
            for k in range(i + 1, p):
                w = w - L[k, i] * eps[k]
            eps[i] = w / L[i, i]
        b_prop = [mu_cur[i] + step_v * eps[i] for i in range(p)]
        lp_prop = log_target(b_prop)
        mu_prop = [c_keep * b_prop[i] + c_pull * c[i] for i in range(p)]
        log_accept = lp_prop - lp + prop_logq(b, mu_prop, c_norm, s2) - prop_logq(b_prop, mu_cur, c_norm, s2)
        accept = torch.log(prng.uniform((n_chains, 1), lambda shape: sites[1])[:, 0]) < log_accept
        b = [torch.where(accept, b_prop[i], b[i]) for i in range(p)]
        lp = torch.where(accept, lp_prop, lp)
        acc = acc + accept.to(torch.float32)
        if adapt and it < n_burn:
            alpha = torch.exp(torch.clamp(log_accept, max=0.0))
            log_step = log_step + rate * (alpha - target)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        out_b[:, idx] = torch.stack(b, dim=1)
        out["log_post"][:, idx] = lp
        out["accept"][:, idx] = accept.to(torch.float32)
    return {"beta": out_b, **out, "accept_total": acc, "log_step": log_step}


class MmalaParams(ctypes.Structure):
    """Mirror of ``struct MmalaParams`` in ``csrc/mmala.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("adapt", ctypes.c_int32),
        ("n_log2pi", ctypes.c_float),
        ("p_log2pi", ctypes.c_float),
        ("half_p", ctypes.c_float),
        ("log_step0", ctypes.c_float),
        ("step", ctypes.c_float),
        ("s2", ctypes.c_float),
        ("c_keep", ctypes.c_float),
        ("c_pull", ctypes.c_float),
        ("c_norm", ctypes.c_float),
        ("target", ctypes.c_float),
        ("rate", ctypes.c_float),
    ]


def _check_inputs(scal, n_chains, p):
    if p < 1 or p > MAX_P:
        raise ValueError(f"fused mMALA supports 1 <= p <= {MAX_P}, got {p}")
    n = 2 * p * p + 3 * p + 4
    if tuple(scal.shape) != (n,) or scal.dtype != torch.float32 or not scal.is_contiguous():
        raise ValueError(f"scal must be a contiguous float32 ({n},) tensor, got {tuple(scal.shape)} {scal.dtype}")
    if n_chains < 1:
        raise ValueError("need n_chains >= 1")


@profiling.traced("kernel.mmala")
def mmala_sweeps_kernel(seed, scal, n_chains, *, p, n_obs, step, adapt, target, rate, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/mmala.cu`` on a CUDA ``scal`` (arguments and results as
    :func:`mmala_sweeps_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(scal, n_chains, p)
    if scal.device.type != "cuda":
        raise ValueError(f"mMALA kernel: expected a CUDA tensor, got {scal.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    fixed = step_constants(p, step)
    prm = MmalaParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn,
        n_thin=n_thin, n_keep=n_keep, adapt=int(bool(adapt)), n_log2pi=n_obs * prng.LOG_2PI,
        p_log2pi=p * prng.LOG_2PI, half_p=0.5 * p, log_step0=math.log(step), target=target, rate=rate, **fixed,
    )
    f32 = dict(dtype=torch.float32, device=scal.device)
    out_b = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("log_post", "accept")}
    last = {k: torch.empty((n_chains,), **f32) for k in ("accept_total", "log_step")}
    lib = _build.library()
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream(scal.device).cuda_stream
        err = lib.mmala_launch(
            ctypes.byref(prm), scal.data_ptr(), out_b.data_ptr(), out["log_post"].data_ptr(),
            out["accept"].data_ptr(), last["accept_total"].data_ptr(), last["log_step"].data_ptr(), stream,
        )
    profiling.count("launch.mmala")
    _build.check(err, "mmala")
    return {"beta": out_b, **out, **last}


def mmala_sweeps(seed, scal, n_chains, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for a CUDA ``scal``, the plain
    version for a CPU one. A CUDA call launches the kernel or raises."""
    if scal.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return mmala_sweeps_kernel(seed, scal, n_chains, **kw)
    if scal.device.type != "cpu":
        raise ValueError(f"mMALA: unsupported device {scal.device}")
    _check_inputs(scal, n_chains, kw["p"])
    return mmala_sweeps_plain(seed, scal, n_chains, bit_source=bit_source, **kw)


def run_fused_mmala(
    seed, X, y, n_burn, n_iter, n_chains, tau=1.0, lam=1.0, step=1.0, ptau_diag=None, plam_diag=None, mu0=None,
    beta0=None, adapt_step=False, target_accept=0.574, adapt_rate=0.05, n_thin=1, device="cuda", bit_source=None,
):
    """Constant-metric manifold MALA for beta | y, p <= 16, the whole run in one launch.

    Arguments as the JAX package's ``run_fused_mmala``: X (N, p), y (N,);
    ``ptau_diag``/``plam_diag`` (default ones), ``mu0``/``beta0`` (default
    zeros); ``n_burn`` the burn-in SWEEP count, ``n_iter`` the stored draws, each
    after ``n_thin`` sweeps. ``device`` is the card unless the caller asks for
    the CPU; ``bit_source(sweep, site, shape)`` replaces Philox (CPU only).
    Returns beta (chains, n_iter, p), log_post and accept (chains, n_iter), and
    accept_total and log_step (chains,)."""
    prep = prepare(X, y, tau=tau, lam=lam, ptau_diag=ptau_diag, plam_diag=plam_diag, mu0=mu0, beta0=beta0)
    p = prep["p"]
    if p > MAX_P:
        raise ValueError(f"fused mMALA supports p <= {MAX_P}, got {p}")
    scal = torch.from_numpy(prep["scal"]).to(device)
    return mmala_sweeps(
        seed, scal, int(n_chains), p=p, n_obs=float(prep["n_obs"]), step=float(step), adapt=bool(adapt_step),
        target=float(target_accept), rate=float(adapt_rate), n_burn=int(n_burn), n_keep=int(n_iter),
        n_thin=int(n_thin), bit_source=bit_source,
    )
