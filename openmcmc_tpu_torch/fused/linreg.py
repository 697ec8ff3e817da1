"""Bayesian linear regression, the whole Gibbs run in one launch, p <= 16 (kernel K6).

Port of ``openmcmc_tpu/fused/linreg.py`` (``run_fused_linreg`` :187, kernel
``_make_kernel`` :50). Model: y ~ N(X beta, (tau diag(ptau))^-1),
beta ~ N(mu, (lam diag(plam))^-1), Gamma priors on tau and lam. The data enter
only through the sufficient statistics

    G = X' P X (p, p),   c = X' P y (p,),   yPy = y' P y,

so a sweep is O(p^2) per chain:

    beta | y, tau, lam ~ N(Q^-1 b, Q^-1),  Q = lam diag(plam) + tau G,  b = lam plam mu + tau c
    tau  | beta        ~ Gamma(a_tau + N/2, b_tau + (yPy - 2 c'beta + beta'G beta) / 2)
    lam  | beta        ~ Gamma(a_lam + p/2, b_lam + (beta - mu)' diag(plam) (beta - mu) / 2)

with beta drawn through an unrolled p x p Cholesky of Q, then tau (first) and
lam as two single Marsaglia-Tsang draws. :func:`linreg_sweeps` runs all sweeps
for all chains: on CUDA tensors it launches ``csrc/linreg.cu``, on CPU tensors
it takes :func:`linreg_sweeps_plain`, the same sweep as a Python loop over
sweeps vectorised over chains. Both add every sum term by term in the JAX
kernel's order: tau's quadratic form cancels heavily (yPy is large and the
residual small), so another order would move tau by far more than rounding.

Bits as in :mod:`openmcmc_tpu_torch.fused.prng`: site 0 holds the p normals,
then come tau's Marsaglia-Tsang sites, then lam's.

Not ported, because they exist for the TPU only: the BLOCK_B lane blocks, the
out_rows sublane padding and the double-buffered store DMAs. A resume
(``init=``) feeds the kernel per-chain ``lam0``/``tau0`` rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import chain_rows, store_index, upload
from openmcmc_tpu_torch.fused.spectral import _lgam
from openmcmc_tpu_torch.utils import profiling

MAX_P = 16


def _specs(a_tau_star: float, a_lam_star: float):
    """tau's and lam's single Gamma specs and the element count of every draw
    site of a sweep after site 0."""
    g_tau = prng._single_spec(a_tau_star, 1)
    n_tau = 2 * g_tau.rounds + g_tau.boost
    g_lam = prng._single_spec(a_lam_star, 1 + n_tau)
    return g_tau, g_lam, [1] * (n_tau + 2 * g_lam.rounds + g_lam.boost)


def sufficient_statistics(X, y, plam, ptau):
    """G = X'PX (p, p), c = X'Py (p,) and ``scal`` = [y'Py, log|diag(plam)|,
    log|P|], float32 on X's device, in the JAX package's operation order
    (full-fp32 matmuls)."""
    XtP = X.mT * ptau[None, :]
    G = torch.matmul(XtP, X)
    c = torch.matmul(XtP, y[:, None]).reshape(-1)
    scal = torch.stack([torch.sum(y * ptau * y), torch.sum(torch.log(plam)), torch.sum(torch.log(ptau))])
    return G.contiguous(), c, scal


@profiling.traced("kernel.linreg")
def linreg_sweeps_plain(seed, G, c, plam, mu, scal, lam0, tau0, *, n_obs, a_lam, b_lam, a_tau, b_tau, n_burn,
                        n_keep, n_thin=1, bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``G`` (p, p), ``c``/``plam``/``mu`` (p,) and ``scal`` (3,) as
    :func:`sufficient_statistics` gives them; ``lam0``/``tau0`` are (chains,);
    ``n_obs`` the number of observations N. ``n_burn`` counts burn-in SWEEPS and
    ``n_keep`` stored draws, each after ``n_thin`` sweeps. Draws come from
    Philox (the kernel's bits) unless ``bit_source(sweep, site, shape)``
    supplies them (CPU tensors only). Returns ``beta`` (chains, n_keep, p) and
    ``lam``/``tau``/``log_post`` (chains, n_keep)."""
    device = G.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    n_chains, p = lam0.shape[0], G.shape[0]
    a_tau_star, a_lam_star = a_tau + 0.5 * n_obs, a_lam + 0.5 * p
    lgam_lam, lgam_tau = _lgam(a_lam, b_lam), _lgam(a_tau, b_tau)
    _, _, gamma_widths = _specs(a_tau_star, a_lam_star)
    widths = [p] + gamma_widths
    f32 = dict(dtype=torch.float32, device=device)
    yPy, ld_plam, ld_ptau = scal.to(**f32).unbind(0)
    Gs, cs, pls, mus = G.to(**f32), c.to(**f32).unbind(0), plam.to(**f32).unbind(0), mu.to(**f32).unbind(0)
    pms = [pl * m for pl, m in zip(pls, mus)]
    out_beta = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("lam", "tau", "log_post")}
    lam, tau = lam0.to(**f32), tau0.to(**f32)
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(widths)]
        draw = prng.SiteStream(sites)
        # NormalNormal: beta | y, tau, lam through the unrolled Cholesky of Q
        z = prng.normal_icdf((n_chains, p), draw).unbind(1)
        L = [[None] * p for _ in range(p)]
        for j in range(p):
            s = lam * pls[j] + tau * Gs[j, j]
            for k in range(j):
                s = s - L[j][k] * L[j][k]
            d = torch.sqrt(s)
            L[j][j] = d
            for i in range(j + 1, p):
                s = tau * Gs[i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                L[i][j] = s / d
        w = []
        for i in range(p):
            s = lam * pms[i] + tau * cs[i]
            for k in range(i):
                s = s - L[i][k] * w[k]
            w.append(s / L[i][i])
        beta = [None] * p
        for i in range(p - 1, -1, -1):
            s = w[i] + z[i]
            for k in range(i + 1, p):
                s = s - L[k][i] * beta[k]
            beta[i] = s / L[i][i]
        # NormalGamma: tau | beta, then lam | beta
        quad_tau = yPy
        for i in range(p):
            quad_tau = quad_tau - 2.0 * cs[i] * beta[i]
            for j in range(p):
                quad_tau = quad_tau + Gs[i, j] * beta[i] * beta[j]
        tau = prng.gamma_mt(a_tau_star, (b_tau + 0.5 * quad_tau)[:, None], draw)[:, 0]
        quad_lam = torch.zeros_like(lam)
        for i in range(p):
            r = beta[i] - mus[i]
            quad_lam = quad_lam + pls[i] * r * r
        lam = prng.gamma_mt(a_lam_star, (b_lam + 0.5 * quad_lam)[:, None], draw)[:, 0]
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        log_like = 0.5 * (n_obs * torch.log(tau) + ld_ptau - n_obs * prng.LOG_2PI - tau * quad_tau)
        log_beta = 0.5 * (p * torch.log(lam) + ld_plam - p * prng.LOG_2PI - lam * quad_lam)
        log_lam = lgam_lam + (a_lam - 1.0) * torch.log(lam) - b_lam * lam
        log_tau = lgam_tau + (a_tau - 1.0) * torch.log(tau) - b_tau * tau
        out_beta[:, idx] = torch.stack(beta, dim=1)
        out["lam"][:, idx] = lam
        out["tau"][:, idx] = tau
        out["log_post"][:, idx] = log_like + log_beta + log_lam + log_tau
    return {"beta": out_beta, **out}


class LinregParams(ctypes.Structure):
    """Mirror of ``struct LinregParams`` in ``csrc/linreg.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("b_lam", ctypes.c_float),
        ("b_tau", ctypes.c_float),
        ("n_obs", ctypes.c_float),
        ("n_log2pi", ctypes.c_float),
        ("p_real", ctypes.c_float),
        ("p_log2pi", ctypes.c_float),
        ("lgam_lam", ctypes.c_float),
        ("lgam_tau", ctypes.c_float),
        ("a_lam_m1", ctypes.c_float),
        ("a_tau_m1", ctypes.c_float),
        ("g_tau", prng.GammaSpec),
        ("g_lam", prng.GammaSpec),
    ]


def _check_inputs(G, c, plam, mu, scal, lam0, tau0):
    p = G.shape[0] if G.dim() == 2 else -1
    if p < 1 or p > MAX_P or tuple(G.shape) != (p, p):
        raise ValueError(f"G must be (p, p) with 1 <= p <= {MAX_P}, got {tuple(G.shape)}")
    if lam0.dim() != 1 or lam0.shape[0] < 1:
        raise ValueError("lam0 must be a non-empty (chains,) tensor")
    named = {"G": (G, (p, p)), "c": (c, (p,)), "plam": (plam, (p,)), "mu": (mu, (p,)), "scal": (scal, (3,)),
             "lam0": (lam0, lam0.shape), "tau0": (tau0, lam0.shape)}
    for name, (t, shape) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != G.device:
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {G.device}")


@profiling.traced("kernel.linreg")
def linreg_sweeps_kernel(seed, G, c, plam, mu, scal, lam0, tau0, *, n_obs, a_lam, b_lam, a_tau, b_tau, n_burn,
                         n_keep, n_thin=1):
    """Launch ``csrc/linreg.cu`` on CUDA tensors (arguments and results as
    :func:`linreg_sweeps_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(G, c, plam, mu, scal, lam0, tau0)
    if G.device.type != "cuda":
        raise ValueError(f"linreg kernel: expected CUDA tensors, got {G.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    n_chains, p = lam0.shape[0], G.shape[0]
    g_tau, g_lam, _ = _specs(a_tau + 0.5 * n_obs, a_lam + 0.5 * p)
    prm = LinregParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn,
        n_thin=n_thin, n_keep=n_keep, b_lam=b_lam, b_tau=b_tau, n_obs=n_obs, n_log2pi=n_obs * prng.LOG_2PI,
        p_real=float(p), p_log2pi=p * prng.LOG_2PI, lgam_lam=_lgam(a_lam, b_lam), lgam_tau=_lgam(a_tau, b_tau),
        a_lam_m1=a_lam - 1.0, a_tau_m1=a_tau - 1.0, g_tau=g_tau, g_lam=g_lam,
    )
    out_beta = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=G.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=G.device)
           for k in ("lam", "tau", "log_post")}
    lib = _build.library()
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        err = lib.linreg_launch(
            ctypes.byref(prm), G.data_ptr(), c.data_ptr(), plam.data_ptr(), mu.data_ptr(), scal.data_ptr(),
            lam0.data_ptr(), tau0.data_ptr(), out_beta.data_ptr(), out["lam"].data_ptr(), out["tau"].data_ptr(),
            out["log_post"].data_ptr(), stream,
        )
    profiling.count("launch.linreg")
    profiling.count("linreg.pipelined")  # every p takes the consumer/worker design (csrc/linreg.cu)
    _build.check(err, "linreg")
    return {"beta": out_beta, **out}


def linreg_sweeps(seed, G, c, plam, mu, scal, lam0, tau0, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU tensors. A CUDA call launches the kernel or raises."""
    if G.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return linreg_sweeps_kernel(seed, G, c, plam, mu, scal, lam0, tau0, **kw)
    if G.device.type != "cpu":
        raise ValueError(f"linreg: unsupported device {G.device}")
    _check_inputs(G, c, plam, mu, scal, lam0, tau0)
    return linreg_sweeps_plain(seed, G, c, plam, mu, scal, lam0, tau0, bit_source=bit_source, **kw)


def _vector(v, n, fill, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=device)
    return upload(v if torch.is_tensor(v) else np.array(v, np.float32), device).reshape(-1)


def run_fused_linreg(
    seed, X, y, n_burn, n_iter, n_chains,
    a_tau=1e-3, b_tau=1e-3, a_lam=1e-3, b_lam=1e-3, lam0=0.01, tau0=1.0, n_thin=1,
    mu=None, plam_diag=None, ptau_diag=None, init=None, device="cuda", bit_source=None,
):
    """Bayesian linear regression, p <= 16, the whole run in one launch.

    Arguments as the JAX package's ``run_fused_linreg``: X (N, p), y (N,);
    ``mu`` (default zeros), ``plam_diag`` and ``ptau_diag`` (default ones) the
    prior mean and the two precision diagonals; ``n_burn`` the burn-in SWEEP
    count, ``n_iter`` the stored draws, each after ``n_thin`` sweeps;
    ``lam0``/``tau0`` scalars or per-chain (chains,) values, replaced by
    ``init``'s per-chain ``lam`` and ``tau`` when given. ``device`` is the
    card unless the caller asks for the CPU; ``bit_source(sweep, site, shape)``
    replaces Philox (CPU only). Returns ``beta`` (chains, n_iter, p) and
    ``lam``/``tau``/``log_post`` (chains, n_iter)."""
    device = torch.device(device)
    with profiling.trace_annotated("fused.prepare"):
        X = upload(X if torch.is_tensor(X) else np.array(X, np.float32), device)
        n_obs, p = X.shape
        if p > MAX_P:
            raise ValueError(f"fused linreg supports p <= {MAX_P}, got {p}")
        y = _vector(y, n_obs, 0.0, device)
        mu, plam = _vector(mu, p, 0.0, device), _vector(plam_diag, p, 1.0, device)
        ptau = _vector(ptau_diag, n_obs, 1.0, device)
        G, c, scal = sufficient_statistics(X, y, plam, ptau)
        rows = chain_rows(n_chains, lam0, tau0, init, device)
    return linreg_sweeps(
        seed, G, c, plam, mu, scal, *rows, n_obs=float(n_obs), a_lam=float(a_lam), b_lam=float(b_lam),
        a_tau=float(a_tau), b_tau=float(b_tau), n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin),
        bit_source=bit_source,
    )
