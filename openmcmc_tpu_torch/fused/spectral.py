"""Spectral GMRF smoother: the whole Gibbs run in pencil eigencoordinates.

Port of the smoother half of ``openmcmc_tpu/fused/spectral.py``
(``_eigenbasis`` :76, ``run_spectral_smoother`` :568, kernel
``_make_smoother_kernel`` :319). Model: y ~ N(b, (tau D)^-1),
b ~ N(mu0, (lam P0)^-1), Gamma priors on lam and tau, for any symmetric PSD P0.

One host-side f64 generalized eigendecomposition, V'DV = I and V'P0V = diag(s),
makes every sweep elementwise in w = V^-1 b:

    w ~ N((tau wy + lam s wmu) / (lam s + tau), 1 / (lam s + tau)),
    wy = V'Dy, wmu = V'D mu0,
    (b - mu0)'P0(b - mu0) = sum s (w - wmu)^2,   (y - b)'D(y - b) = sum (wy - w)^2,

and the stored latent is b = V w. :func:`smoother_sweeps` runs all sweeps for
all chains: on a CUDA tensor it launches ``csrc/spectral_smoother.cu``, on a CPU
tensor it takes :func:`smoother_sweeps_plain`, the same sweep as a Python loop
over sweeps vectorised over chains.

Not ported, because they exist for the TPU only: the sublane/lane padding and its
mask, the VMEM lane-block budget, the double-buffered store DMAs, the
direct/transposed store layouts, and ``Precision.HIGHEST`` plumbing.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import store_index

MAX_P_SMOOTHER = 1024  # tridiagonal P0 past this goes to the Thomas kernel (K4, fused/gmrf_smoother.py)
MAX_P_SMOOTHER_STREAM = 8192  # any other P0: the host eigendecomposition bounds p

_EIG_CACHE: dict = {}  # (P0 bytes, noise-diagonal bytes) -> (V, s); capacity 8


def _eigenbasis(G: np.ndarray, plam: np.ndarray):
    """Host-side f64 generalized eigendecomposition of the (G, diag(plam)) pencil:
    V' diag(plam) V = I and V' G V = diag(s), s >= 0. Same call as the JAX
    package's, so that eigenvector signs (and hence w) agree."""
    rt = 1.0 / np.sqrt(plam.astype(np.float64))
    Gt = rt[:, None] * G.astype(np.float64) * rt[None, :]
    s, U = np.linalg.eigh((Gt + Gt.T) / 2.0)
    s = np.maximum(s, 0.0)
    V = rt[:, None] * U
    return V, s


def prepare(y, P0, noise_diag=None, mu0=None, logdet_p0=None):
    """Host preparation of :func:`run_spectral_smoother`, all f64 numpy:
    ``V`` (p, p), ``s``, ``wy``, ``wmu`` (p,), ``logdet_d`` and ``logdet_p0``.

    ``logdet_p0=None`` takes log|D| + sum log s (arbitrary but finite for a
    singular P0, as in the JAX package); the dispatcher passes the structured
    Cholesky value instead so that log_post matches ``Model.log_p``."""
    y = np.asarray(y, np.float64).reshape(-1)
    p = y.shape[0]
    if p > MAX_P_SMOOTHER_STREAM:
        raise ValueError(f"spectral smoother supports p <= {MAX_P_SMOOTHER_STREAM}, got {p}")
    P0 = np.asarray(P0, np.float64)
    d_vec = np.ones(p) if noise_diag is None else np.asarray(noise_diag, np.float64).reshape(-1)
    mu0 = np.zeros(p) if mu0 is None else np.asarray(mu0, np.float64).reshape(-1)
    cache_key = (P0.tobytes(), d_vec.tobytes())
    hit = _EIG_CACHE.get(cache_key)
    if hit is None:
        hit = _eigenbasis(P0, d_vec)
        if len(_EIG_CACHE) >= 8:
            _EIG_CACHE.pop(next(iter(_EIG_CACHE)))
        _EIG_CACHE[cache_key] = hit
    V, s = hit
    logdet_d = float(np.sum(np.log(d_vec)))
    if logdet_p0 is None:
        logdet_p0 = logdet_d + float(np.sum(np.log(np.maximum(s, 1e-300))))
    return {
        "V": V, "s": s, "wy": V.T @ (d_vec * y), "wmu": V.T @ (d_vec * mu0),
        "logdet_d": logdet_d, "logdet_p0": float(logdet_p0),
    }


class SmootherParams(ctypes.Structure):
    """Mirror of ``struct SmootherParams`` in ``csrc/spectral_smoother.cu``."""

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
        ("p_real", ctypes.c_float),
        ("p_log2pi", ctypes.c_float),
        ("logdet_p0", ctypes.c_float),
        ("logdet_d", ctypes.c_float),
        ("lgam_lam", ctypes.c_float),
        ("lgam_tau", ctypes.c_float),
        ("a_lam_m1", ctypes.c_float),
        ("a_tau_m1", ctypes.c_float),
        ("g_lam", prng.GammaSpec),
        ("g_tau", prng.GammaSpec),
    ]


def _lgam(a: float, b: float) -> float:
    """The Gamma(a, b) log-density's constant a log b - lgamma(a)."""
    return float(a * np.log(b) - math.lgamma(a))


def smoother_sweeps_plain(seed, V, s, wy, wmu, lam0, tau0, *, logdet_p0, logdet_d, a_lam, b_lam,
                          a_tau, b_tau, n_burn, n_keep, n_thin=1, bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``V`` is the (p, p) float32 eigenbasis (field rows), ``s``/``wy``/``wmu`` are
    (p,), ``lam0``/``tau0`` are (chains,) initial scales, ``n_burn`` counts burn-in
    SWEEPS and ``n_keep`` stored draws, each after ``n_thin`` sweeps. Draws come
    from Philox (the kernel's bits) unless ``bit_source(sweep, site, shape)``
    supplies them; that hook takes CPU tensors only. Returns ``b``
    (chains, n_keep, p) and ``lam``/``tau``/``log_post`` (chains, n_keep)."""
    device = V.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    n_chains, p = lam0.shape[0], V.shape[0]
    p_real = float(p)
    a_lam_star, a_tau_star = a_lam + 0.5 * p_real, a_tau + 0.5 * p_real
    lgam_lam, lgam_tau = _lgam(a_lam, b_lam), _lgam(a_tau, b_tau)
    _, _, gamma_widths = prng.gamma_pair_specs(a_lam_star, a_tau_star)
    widths = [p] + gamma_widths
    f32 = dict(dtype=torch.float32, device=device)
    svec, wy, wmu = (torch.as_tensor(v, **f32)[None, :] for v in (s, wy, wmu))
    ld_p0, ld_d = torch.tensor(logdet_p0, **f32), torch.tensor(logdet_d, **f32)
    out_b = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("lam", "tau", "log_post")}
    lam, tau = lam0.to(**f32).reshape(-1, 1), tau0.to(**f32).reshape(-1, 1)
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(widths)]
        draw = prng.SiteStream(sites)
        # NormalNormal: b | y, lam, tau is diagonal in w = V^-1 b
        z = prng.normal_icdf((n_chains, p), draw)
        d = lam * svec + tau
        w = (tau * wy + lam * svec * wmu) / d + z * torch.rsqrt(d)
        # NormalGamma pair: both quadratic forms are elementwise in w
        r = w - wmu
        quad_lam = torch.sum(svec * r * r, dim=1, keepdim=True)
        t = wy - w
        quad_tau = torch.sum(t * t, dim=1, keepdim=True)
        lam, tau = prng.gamma_mt2(a_lam_star, a_tau_star, b_lam + 0.5 * quad_lam, b_tau + 0.5 * quad_tau, draw)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        log_like = 0.5 * (p_real * torch.log(tau) + ld_d - p_real * prng.LOG_2PI - tau * quad_tau)
        log_prior_b = 0.5 * (p_real * torch.log(lam) + ld_p0 - p_real * prng.LOG_2PI - lam * quad_lam)
        log_lam = lgam_lam + (a_lam - 1.0) * torch.log(lam) - b_lam * lam
        log_tau = lgam_tau + (a_tau - 1.0) * torch.log(tau) - b_tau * tau
        out_b[:, idx] = torch.matmul(w, V.T)
        out["lam"][:, idx] = lam[:, 0]
        out["tau"][:, idx] = tau[:, 0]
        out["log_post"][:, idx] = (log_like + log_prior_b + log_lam + log_tau)[:, 0]
    return {"b": out_b, **out}


def _check_inputs(V, s, wy, wmu, lam0, tau0):
    p = V.shape[0]
    if V.dim() != 2 or V.shape[1] != p:
        raise ValueError(f"V must be (p, p), got {tuple(V.shape)}")
    for name, t, n in (("s", s, p), ("wy", wy, p), ("wmu", wmu, p), ("tau0", tau0, lam0.shape[0])):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    if lam0.dim() != 1 or lam0.shape[0] < 1:
        raise ValueError("lam0 must be a non-empty (chains,) tensor")
    for name, t in (("V", V), ("s", s), ("wy", wy), ("wmu", wmu), ("lam0", lam0), ("tau0", tau0)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != V.device:
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {V.device}")


def smoother_sweeps_kernel(seed, V, s, wy, wmu, lam0, tau0, *, logdet_p0, logdet_d, a_lam, b_lam,
                           a_tau, b_tau, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/spectral_smoother.cu`` on CUDA tensors (arguments as
    :func:`smoother_sweeps_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(V, s, wy, wmu, lam0, tau0)
    if V.device.type != "cuda":
        raise ValueError(f"spectral smoother kernel: expected CUDA tensors, got {V.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    n_chains, p = lam0.shape[0], V.shape[0]
    p_real = float(p)
    g_lam, g_tau, _ = prng.gamma_pair_specs(a_lam + 0.5 * p_real, a_tau + 0.5 * p_real)
    prm = SmootherParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin,
        n_burn=n_burn, n_thin=n_thin, n_keep=n_keep, b_lam=b_lam, b_tau=b_tau,
        p_real=p_real, p_log2pi=p_real * prng.LOG_2PI, logdet_p0=logdet_p0, logdet_d=logdet_d,
        lgam_lam=_lgam(a_lam, b_lam), lgam_tau=_lgam(a_tau, b_tau),
        a_lam_m1=a_lam - 1.0, a_tau_m1=a_tau - 1.0, g_lam=g_lam, g_tau=g_tau,
    )
    VT = V.t().contiguous()
    out_b = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=V.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=V.device)
           for k in ("lam", "tau", "log_post")}
    lib = _build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        err = lib.spectral_smoother_launch(
            ctypes.byref(prm), VT.data_ptr(), s.data_ptr(), wy.data_ptr(), wmu.data_ptr(),
            lam0.data_ptr(), tau0.data_ptr(), out_b.data_ptr(), out["lam"].data_ptr(),
            out["tau"].data_ptr(), out["log_post"].data_ptr(), stream,
        )
    smoother_sweeps_kernel.launches += 1
    _build.check(err, "spectral_smoother")
    return {"b": out_b, **out}


smoother_sweeps_kernel.launches = 0


def smoother_sweeps(seed, V, s, wy, wmu, lam0, tau0, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU tensors. A CUDA call launches the kernel or raises."""
    if V.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return smoother_sweeps_kernel(seed, V, s, wy, wmu, lam0, tau0, **kw)
    if V.device.type != "cpu":
        raise ValueError(f"spectral smoother: unsupported device {V.device}")
    _check_inputs(V, s, wy, wmu, lam0, tau0)
    return smoother_sweeps_plain(seed, V, s, wy, wmu, lam0, tau0, bit_source=bit_source, **kw)


def run_spectral_smoother(
    seed, y, P0, n_burn, n_iter, n_chains,
    a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, lam0=100.0, tau0=1.0,
    noise_diag=None, mu0=None, logdet_p0=None, n_thin=1, device="cuda", bit_source=None,
):
    """GMRF smoother with any symmetric PSD prior precision, p <= 8192, one launch.

    Arguments as the JAX package's ``run_spectral_smoother``: ``n_burn`` is the
    burn-in SWEEP count, ``n_iter`` the stored draws, each after ``n_thin``
    sweeps. ``lam0``/``tau0`` are scalars or per-chain (chains,) values.
    ``device`` is the card unless the caller asks for the CPU.
    ``bit_source(sweep, site, shape)`` replaces Philox (CPU only). Returns
    ``b`` (chains, n_iter, p) and ``lam``/``tau``/``log_post`` (chains, n_iter)."""
    prep = prepare(y, P0, noise_diag=noise_diag, mu0=mu0, logdet_p0=logdet_p0)
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    rows = [torch.as_tensor(v, **f32).reshape(-1).expand(n_chains).contiguous() for v in (lam0, tau0)]
    return smoother_sweeps(
        seed, torch.as_tensor(prep["V"], **f32), *(torch.as_tensor(prep[k], **f32) for k in ("s", "wy", "wmu")),
        *rows, logdet_p0=float(np.float32(prep["logdet_p0"])), logdet_d=float(np.float32(prep["logdet_d"])),
        a_lam=float(a_lam), b_lam=float(b_lam), a_tau=float(a_tau), b_tau=float(b_tau),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), bit_source=bit_source,
    )
