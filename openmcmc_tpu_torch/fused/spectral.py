"""Spectral engines: whole runs in pencil eigencoordinates.

Port of the smoother, linear-regression and mMALA parts of
``openmcmc_tpu/fused/spectral.py`` (``_eigenbasis`` :76; the smoother
``run_spectral_smoother`` :568 with kernel ``_make_smoother_kernel`` :319, K1;
linear regression ``run_spectral_linreg`` :265 with kernel
``_make_linreg_kernel`` :94, K5). The smoother's model: y ~ N(b, (tau D)^-1),
b ~ N(mu0, (lam P0)^-1), Gamma priors on lam and tau, for any symmetric PSD P0.

One host-side f64 generalized eigendecomposition, V'DV = I and V'P0V = diag(s),
makes every sweep elementwise in w = V^-1 b:

    w ~ N((tau wy + lam s wmu) / (lam s + tau), 1 / (lam s + tau)),
    wy = V'Dy, wmu = V'D mu0,
    (b - mu0)'P0(b - mu0) = sum s (w - wmu)^2,   (y - b)'D(y - b) = sum (wy - w)^2,

and the stored latent is b = V w. :func:`smoother_sweeps` runs all sweeps for
all chains: on a CUDA tensor it launches ``csrc/spectral_smoother.cu`` and, for
p <= MAX_P, the store kernel below, on a CPU tensor it takes
:func:`smoother_sweeps_plain`, the same sweep as a Python loop over sweeps
vectorised over chains.

Linear regression, y ~ N(X beta, (tau diag(ptau))^-1),
beta ~ N(mu, (lam diag(plam))^-1), p <= 256, uses the pencil of G = X'PX and
diag(plam): V' diag(plam) V = I, V'GV = diag(s), and in w = V^-1 beta

    w ~ N((lam wmu + tau cv) / d, 1 / d),  d = lam + tau s,  wmu = V' plam mu,  cv = V'c,
    (beta - mu)' diag(plam) (beta - mu) = sum (w - wmu)^2,
    (y - X beta)' P (y - X beta) = y'Py - 2 sum cv w + sum s w^2   (clamped at 0),

then (tau, lam) as one Gamma pair and beta = V w on stored sweeps.
:func:`spectral_linreg_sweeps` launches ``csrc/spectral_linreg.cu``, which writes
each stored w into beta's row, and then ``csrc/spectral_store.cu``
(:func:`spectral_store_kernel`), which turns every stored row into beta = V w in
place, as the JAX kernel's block product on the MXU does; it takes
:func:`spectral_linreg_sweeps_plain` for CPU tensors. Its three
sums run in one fixed order in both (:func:`window_sums`): tau's form cancels
heavily, and another order would move tau by far more than rounding.

Constant-metric manifold MALA (``run_spectral_mmala`` :867 with kernel
``_make_mmala_kernel`` :655, K9) takes the same pencil with the metric
A = tau G + lam diag(plam), eigenvalues d = tau s + lam, and runs every proposal,
density and accept elementwise in w = V^-1 beta, with beta = V w on stored
sweeps. :func:`spectral_mmala_sweeps` launches ``csrc/spectral_mmala.cu`` and
then the same store kernel for CUDA tensors and takes
:func:`spectral_mmala_sweeps_plain` for CPU tensors; its three sums run in K5's
window order. Two departures: the log target is taken
about its mode, log_const - 1/2 sum d (w - vw/d)^2 with the constant in float64 on
the host, where the JAX kernel sums -1/2 (sum d w^2 + yPy) + sum vw w in float32,
which at yPy ~ 5e7 (N = 2048, P = 100 I) rounds by more than the accept ratio
itself; and the adapted log step is one value per chain, where the JAX kernel
carries it at full (p_pad, chains) shape for a Mosaic limitation.

Not ported, because they exist for the TPU only: the sublane/lane padding and its
mask, the VMEM lane-block budget, the double-buffered store DMAs, the
direct/transposed store layouts, and ``Precision.HIGHEST`` plumbing.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import chain_rows, store_index, upload
from openmcmc_tpu_torch.utils import profiling

MAX_P = 256  # the store kernel's widest tile; past it spectral linear regression is not matched
PAD = 8  # p is rounded up to this in the JAX kernel's (p_pad, chains) sums
SUM_WINDOW = 32
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
        ("store_w", ctypes.c_int32),
    ]


def _lgam(a: float, b: float) -> float:
    """The Gamma(a, b) log-density's constant a log b - lgamma(a)."""
    return float(a * np.log(b) - math.lgamma(a))


@profiling.traced("kernel.spectral_smoother")
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


def _check_inputs(V, vectors: dict, lam0, tau0):
    """V (p, p), the named (p,) vectors and the (chains,) rows, all contiguous
    float32 on V's device."""
    p = V.shape[0]
    if V.dim() != 2 or V.shape[1] != p:
        raise ValueError(f"V must be (p, p), got {tuple(V.shape)}")
    if lam0.dim() != 1 or lam0.shape[0] < 1:
        raise ValueError("lam0 must be a non-empty (chains,) tensor")
    named = {**{k: (t, p) for k, t in vectors.items()}, "lam0": (lam0, lam0.shape[0]), "tau0": (tau0, lam0.shape[0])}
    for name, (t, n) in named.items():
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    for name, t in (("V", V), *((k, t) for k, (t, _) in named.items())):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != V.device:
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {V.device}")


@profiling.traced("kernel.spectral_smoother")
def smoother_sweeps_kernel(seed, V, s, wy, wmu, lam0, tau0, *, logdet_p0, logdet_d, a_lam, b_lam,
                           a_tau, b_tau, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/spectral_smoother.cu`` on CUDA tensors (arguments as
    :func:`smoother_sweeps_plain`). Where p <= MAX_P it writes each stored
    sweep's w into b's row and :func:`spectral_store_kernel` then turns the rows
    into b = V w (counter ``spectral_smoother.store_kernel``); above, past the
    store kernel's widest tile, it computes b = V w itself. Launches on the
    current stream, does not synchronise."""
    _check_inputs(V, {"s": s, "wy": wy, "wmu": wmu}, lam0, tau0)
    if V.device.type != "cuda":
        raise ValueError(f"spectral smoother kernel: expected CUDA tensors, got {V.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    n_chains, p = lam0.shape[0], V.shape[0]
    p_real = float(p)
    store_w = p <= MAX_P
    g_lam, g_tau, _ = prng.gamma_pair_specs(a_lam + 0.5 * p_real, a_tau + 0.5 * p_real)
    prm = SmootherParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin,
        n_burn=n_burn, n_thin=n_thin, n_keep=n_keep, b_lam=b_lam, b_tau=b_tau,
        p_real=p_real, p_log2pi=p_real * prng.LOG_2PI, logdet_p0=logdet_p0, logdet_d=logdet_d,
        lgam_lam=_lgam(a_lam, b_lam), lgam_tau=_lgam(a_tau, b_tau),
        a_lam_m1=a_lam - 1.0, a_tau_m1=a_tau - 1.0, g_lam=g_lam, g_tau=g_tau, store_w=store_w,
    )
    VT = None if store_w else V.t().contiguous()
    out_b = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=V.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=V.device)
           for k in ("lam", "tau", "log_post")}
    lib = _build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        err = lib.spectral_smoother_launch(
            ctypes.byref(prm), None if VT is None else VT.data_ptr(), s.data_ptr(), wy.data_ptr(),
            wmu.data_ptr(), lam0.data_ptr(), tau0.data_ptr(), out_b.data_ptr(), out["lam"].data_ptr(),
            out["tau"].data_ptr(), out["log_post"].data_ptr(), stream,
        )
    profiling.count("launch.spectral_smoother")
    _build.check(err, "spectral_smoother")
    if store_w:
        profiling.count("spectral_smoother.store_kernel")
        spectral_store_kernel(out_b, V)
    return {"b": out_b, **out}


def smoother_sweeps(seed, V, s, wy, wmu, lam0, tau0, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU tensors. A CUDA call launches the kernel or raises."""
    if V.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return smoother_sweeps_kernel(seed, V, s, wy, wmu, lam0, tau0, **kw)
    if V.device.type != "cpu":
        raise ValueError(f"spectral smoother: unsupported device {V.device}")
    _check_inputs(V, {"s": s, "wy": wy, "wmu": wmu}, lam0, tau0)
    return smoother_sweeps_plain(seed, V, s, wy, wmu, lam0, tau0, bit_source=bit_source, **kw)


def run_spectral_smoother(
    seed, y, P0, n_burn, n_iter, n_chains,
    a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, lam0=100.0, tau0=1.0,
    noise_diag=None, mu0=None, logdet_p0=None, init=None, n_thin=1, device="cuda", bit_source=None,
):
    """GMRF smoother with any symmetric PSD prior precision, p <= 8192, one launch.

    Arguments as the JAX package's ``run_spectral_smoother``: ``n_burn`` is the
    burn-in SWEEP count, ``n_iter`` the stored draws, each after ``n_thin``
    sweeps. ``lam0``/``tau0`` are scalars or per-chain (chains,) values;
    ``init``, a dict of per-chain ``lam`` and ``tau`` (chains,), replaces them
    (the warm start of a resume).
    ``device`` is the card unless the caller asks for the CPU.
    ``bit_source(sweep, site, shape)`` replaces Philox (CPU only). Returns
    ``b`` (chains, n_iter, p) and ``lam``/``tau``/``log_post`` (chains, n_iter)."""
    with profiling.trace_annotated("fused.prepare"):
        prep = prepare(y, P0, noise_diag=noise_diag, mu0=mu0, logdet_p0=logdet_p0)
        rows = chain_rows(n_chains, lam0, tau0, init, device)
        V, s, wy, wmu = (upload(prep[k], device) for k in ("V", "s", "wy", "wmu"))
    return smoother_sweeps(
        seed, V, s, wy, wmu, *rows, logdet_p0=float(np.float32(prep["logdet_p0"])), logdet_d=float(np.float32(prep["logdet_d"])),
        a_lam=float(a_lam), b_lam=float(b_lam), a_tau=float(a_tau), b_tau=float(b_tau),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), bit_source=bit_source,
    )


# ---------------------------------------------------------------------------
# linear regression (kernel K5)
# ---------------------------------------------------------------------------


def _f64(v) -> np.ndarray:
    """A host f64 copy of an array, number or tensor (on any device)."""
    return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)


def prepare_linreg(X, y, mu=None, plam_diag=None, ptau_diag=None):
    """Host preparation of :func:`run_spectral_linreg`, all f64 numpy, as the
    JAX package does it: ``V`` (p, p), ``s``, ``wmu``, ``cv`` (p,), and
    ``yPy``, ``logdet_plam``, ``logdet_ptau``, ``n_obs``."""
    X = _f64(X)
    y = _f64(y).reshape(-1)
    n_obs, p = X.shape
    if p > MAX_P:
        raise ValueError(f"spectral linreg supports p <= {MAX_P}, got {p}")
    mu = np.zeros(p) if mu is None else _f64(mu).reshape(-1)
    plam = np.ones(p) if plam_diag is None else _f64(plam_diag).reshape(-1)
    ptau = np.ones(n_obs) if ptau_diag is None else _f64(ptau_diag).reshape(-1)
    XtP = X.T * ptau[None, :]
    G = XtP @ X
    c = (XtP @ y).reshape(-1)
    V, s = _eigenbasis(G, plam)
    return {
        "V": V, "s": s, "wmu": V.T @ (plam * mu), "cv": V.T @ c, "yPy": float(np.sum(y * ptau * y)),
        "logdet_plam": float(np.sum(np.log(plam))), "logdet_ptau": float(np.sum(np.log(ptau))), "n_obs": n_obs,
    }


def sum_windows(p: int):
    """The fixed order of K5's sums over p eigencoordinates: p rounded up to
    PAD, then windows of SUM_WINDOW rows with the rounding to whole windows
    split between both ends (``lo`` rows before row 0), each window summed in
    row order and the window sums in order. This is the order XLA's CPU
    reduction takes for the JAX kernel's (p_pad, chains) sums, so the plain
    version reproduces the JAX package, and it lets the kernel sum the windows
    on separate lanes. Returns (windows, lo)."""
    p_pad = p + (-p) % PAD
    n_win = -(-p_pad // SUM_WINDOW)
    return n_win, (n_win * SUM_WINDOW - p_pad) // 2


def window_sums(terms: torch.Tensor) -> torch.Tensor:
    """Sum (chains, k, p) terms over the last axis in :func:`sum_windows`'
    order; returns (chains, k). Zero rows pad the windows (adding 0 is exact)."""
    n_win, lo = sum_windows(terms.shape[-1])
    padded = F.pad(terms, (lo, n_win * SUM_WINDOW - lo - terms.shape[-1]))
    rows = padded.reshape(terms.shape[:-1] + (n_win, SUM_WINDOW)).unbind(-1)
    part = torch.zeros_like(rows[0])
    for row in rows:
        part = part + row
    total = torch.zeros_like(part[..., 0])
    for win in part.unbind(-1):
        total = total + win
    return total


# ---------------------------------------------------------------------------
# the stored draws of K1 (p <= MAX_P), K5 and K9: b = V w over every stored row at once
# ---------------------------------------------------------------------------

STORE_DEPTH = 16  # csrc/spectral_store.cu's k-tile rows (kDepth)
STORE_COLS = (128, 256)  # its column tiles (kCols); the narrowest that holds p is taken


@profiling.traced("kernel.spectral_store")
def spectral_store_plain(w, V):
    """Plain version of the store kernel: beta = w V' for (..., p) rows w."""
    return torch.matmul(w, V.T)


def store_operand(V):
    """V' as ``csrc/spectral_store.cu`` takes it: (p rounded up to STORE_DEPTH,
    the narrowest of STORE_COLS that holds p), V' in the top-left (p, p) block.
    The padding is left unset: the kernel sums no padded k and stores no padded
    column."""
    p = V.shape[0]
    cols = next(c for c in STORE_COLS if p <= c)
    vt = torch.empty((-(-p // STORE_DEPTH) * STORE_DEPTH, cols), dtype=torch.float32, device=V.device)
    vt[:p, :p] = V.t()
    return vt


@profiling.traced("kernel.spectral_store")
def spectral_store_kernel(rows, V):
    """Launch ``csrc/spectral_store.cu``: the (..., p) ``rows`` (contiguous
    float32 on the card, p <= MAX_P) become rows V' in place, each output summed
    by fmaf in ascending k, V' handed over as :func:`store_operand` pads it.
    Launches on the current stream, does not synchronise; returns ``rows``."""
    p = V.shape[0]
    if V.dim() != 2 or V.shape[1] != p or not 1 <= p <= MAX_P:
        raise ValueError(f"spectral store: V must be (p, p) with p <= {MAX_P}, got {tuple(V.shape)}")
    if rows.dim() < 1 or rows.shape[-1] != p:
        raise ValueError(f"spectral store: rows must end in p = {p}, got {tuple(rows.shape)}")
    for name, t in (("rows", rows), ("V", V)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous() or t.device != V.device:
            raise ValueError(f"spectral store: {name} must be a contiguous float32 tensor on one CUDA device, got "
                             f"{t.dtype} on {t.device}")
    from openmcmc_tpu_torch import _build

    vt = store_operand(V)
    lib = _build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        err = lib.spectral_store_launch(rows.data_ptr(), vt.data_ptr(), p, vt.shape[1], rows.numel() // p,
                                        stream)
    profiling.count("launch.spectral_store")
    _build.check(err, "spectral_store")
    return rows


@profiling.traced("kernel.spectral_linreg")
def spectral_linreg_sweeps_plain(seed, V, s, wmu, cv, lam0, tau0, *, yPy, logdet_plam, logdet_ptau, n_obs, a_lam,
                                 b_lam, a_tau, b_tau, n_burn, n_keep, n_thin=1, bit_source=None):
    """Plain PyTorch version of the K5 kernel: all sweeps for all chains.

    ``V`` is the (p, p) float32 eigenbasis (beta rows), ``s``/``wmu``/``cv``
    are (p,), ``lam0``/``tau0`` (chains,) initial scales, ``yPy`` and the two
    log-determinants float32 values, ``n_obs`` the number of observations;
    ``n_burn`` counts burn-in SWEEPS and ``n_keep`` stored draws, each after
    ``n_thin`` sweeps. Draws come from Philox unless ``bit_source(sweep, site,
    shape)`` supplies them (CPU tensors only). Returns ``beta``
    (chains, n_keep, p) and ``lam``/``tau``/``log_post`` (chains, n_keep)."""
    device = V.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    n_chains, p = lam0.shape[0], V.shape[0]
    p_real = float(p)
    a_tau_star, a_lam_star = a_tau + 0.5 * n_obs, a_lam + 0.5 * p_real
    lgam_lam, lgam_tau = _lgam(a_lam, b_lam), _lgam(a_tau, b_tau)
    _, _, gamma_widths = prng.gamma_pair_specs(a_tau_star, a_lam_star)
    widths = [p] + gamma_widths
    f32 = dict(dtype=torch.float32, device=device)
    svec, wmu, cv = (torch.as_tensor(v, **f32)[None, :] for v in (s, wmu, cv))
    ld_plam, ld_ptau = torch.tensor(logdet_plam, **f32), torch.tensor(logdet_ptau, **f32)
    out_beta = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("lam", "tau", "log_post")}
    lam, tau = lam0.to(**f32).reshape(-1, 1), tau0.to(**f32).reshape(-1, 1)
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(widths)]
        draw = prng.SiteStream(sites)
        # NormalNormal: beta | y, lam, tau is diagonal in w = V^-1 beta
        z = prng.normal_icdf((n_chains, p), draw)
        d = lam + tau * svec
        w = (lam * wmu + tau * cv) / d + z * torch.rsqrt(d)
        # NormalGamma pair (tau, lam): both quadratic forms are sums over w
        r = w - wmu
        sums = window_sums(torch.stack([r * r, cv * w, svec * w * w], dim=1))
        quad_lam = sums[:, 0:1]
        quad_tau = torch.clamp(yPy - 2.0 * sums[:, 1:2] + sums[:, 2:3], min=0.0)
        tau, lam = prng.gamma_mt2(a_tau_star, a_lam_star, b_tau + 0.5 * quad_tau, b_lam + 0.5 * quad_lam, draw)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        log_like = 0.5 * (n_obs * torch.log(tau) + ld_ptau - n_obs * prng.LOG_2PI - tau * quad_tau)
        log_beta = 0.5 * (p_real * torch.log(lam) + ld_plam - p_real * prng.LOG_2PI - lam * quad_lam)
        log_lam = lgam_lam + (a_lam - 1.0) * torch.log(lam) - b_lam * lam
        log_tau = lgam_tau + (a_tau - 1.0) * torch.log(tau) - b_tau * tau
        out_beta[:, idx] = spectral_store_plain(w, V)
        out["lam"][:, idx] = lam[:, 0]
        out["tau"][:, idx] = tau[:, 0]
        out["log_post"][:, idx] = (log_like + log_beta + log_lam + log_tau)[:, 0]
    return {"beta": out_beta, **out}


class LinregWideParams(ctypes.Structure):
    """Mirror of ``struct LinregWideParams`` in ``csrc/spectral_linreg.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("sum_windows", ctypes.c_int32),
        ("sum_lo", ctypes.c_int32),
        ("yPy", ctypes.c_float),
        ("logdet_plam", ctypes.c_float),
        ("logdet_ptau", ctypes.c_float),
        ("n_obs", ctypes.c_float),
        ("n_log2pi", ctypes.c_float),
        ("p_real", ctypes.c_float),
        ("p_log2pi", ctypes.c_float),
        ("b_lam", ctypes.c_float),
        ("b_tau", ctypes.c_float),
        ("lgam_lam", ctypes.c_float),
        ("lgam_tau", ctypes.c_float),
        ("a_lam_m1", ctypes.c_float),
        ("a_tau_m1", ctypes.c_float),
        ("g_tau", prng.GammaSpec),
        ("g_lam", prng.GammaSpec),
    ]


@profiling.traced("kernel.spectral_linreg")
def spectral_linreg_sweeps_kernel(seed, V, s, wmu, cv, lam0, tau0, *, yPy, logdet_plam, logdet_ptau, n_obs, a_lam,
                                  b_lam, a_tau, b_tau, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/spectral_linreg.cu`` on CUDA tensors (arguments and results
    as :func:`spectral_linreg_sweeps_plain`), which writes each stored sweep's w
    into beta's row, then :func:`spectral_store_kernel` over the rows. Both
    launch on the current stream; nothing synchronises."""
    _check_inputs(V, {"s": s, "wmu": wmu, "cv": cv}, lam0, tau0)
    if V.device.type != "cuda":
        raise ValueError(f"spectral linreg kernel: expected CUDA tensors, got {V.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    n_chains, p = lam0.shape[0], V.shape[0]
    if p > MAX_P:
        raise ValueError(f"spectral linreg supports p <= {MAX_P}, got {p}")
    g_tau, g_lam, _ = prng.gamma_pair_specs(a_tau + 0.5 * n_obs, a_lam + 0.5 * p)
    n_win, lo = sum_windows(p)
    prm = LinregWideParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn,
        n_thin=n_thin, n_keep=n_keep, sum_windows=n_win, sum_lo=lo, yPy=yPy, logdet_plam=logdet_plam,
        logdet_ptau=logdet_ptau, n_obs=n_obs, n_log2pi=n_obs * prng.LOG_2PI, p_real=float(p),
        p_log2pi=p * prng.LOG_2PI, b_lam=b_lam, b_tau=b_tau, lgam_lam=_lgam(a_lam, b_lam),
        lgam_tau=_lgam(a_tau, b_tau), a_lam_m1=a_lam - 1.0, a_tau_m1=a_tau - 1.0, g_tau=g_tau, g_lam=g_lam,
    )
    out_beta = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=V.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=V.device)
           for k in ("lam", "tau", "log_post")}
    lib = _build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        err = lib.spectral_linreg_launch(
            ctypes.byref(prm), s.data_ptr(), wmu.data_ptr(), cv.data_ptr(), lam0.data_ptr(), tau0.data_ptr(),
            out_beta.data_ptr(), out["lam"].data_ptr(), out["tau"].data_ptr(), out["log_post"].data_ptr(), stream,
        )
    profiling.count("launch.spectral_linreg")
    _build.check(err, "spectral_linreg")
    spectral_store_kernel(out_beta, V)
    return {"beta": out_beta, **out}


def spectral_linreg_sweeps(seed, V, s, wmu, cv, lam0, tau0, *, bit_source=None, **kw):
    """All sweeps for all chains: the K5 kernel for CUDA tensors, the plain
    version for CPU tensors. A CUDA call launches the kernel or raises."""
    if V.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return spectral_linreg_sweeps_kernel(seed, V, s, wmu, cv, lam0, tau0, **kw)
    if V.device.type != "cpu":
        raise ValueError(f"spectral linreg: unsupported device {V.device}")
    _check_inputs(V, {"s": s, "wmu": wmu, "cv": cv}, lam0, tau0)
    return spectral_linreg_sweeps_plain(seed, V, s, wmu, cv, lam0, tau0, bit_source=bit_source, **kw)


def run_spectral_linreg(
    seed, X, y, n_burn, n_iter, n_chains,
    a_tau=1e-3, b_tau=1e-3, a_lam=1e-3, b_lam=1e-3, lam0=0.01, tau0=1.0,
    mu=None, plam_diag=None, ptau_diag=None, init=None, n_thin=1, device="cuda", bit_source=None,
):
    """Bayesian linear regression, p <= 256, the whole run in one launch.

    Model, arguments and results as :func:`openmcmc_tpu_torch.fused.linreg.
    run_fused_linreg` (``beta`` (chains, n_iter, p), ``lam``/``tau``/``log_post``
    (chains, n_iter)); the host does one f64 generalized eigendecomposition
    instead of a Cholesky per sweep; ``init`` (per-chain ``lam`` and ``tau``)
    replaces lam0/tau0. ``device`` is the card unless the caller asks for the
    CPU; ``bit_source(sweep, site, shape)`` replaces Philox (CPU only)."""
    prep = prepare_linreg(X, y, mu=mu, plam_diag=plam_diag, ptau_diag=ptau_diag)
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    rows = chain_rows(n_chains, lam0, tau0, init, device)
    return spectral_linreg_sweeps(
        seed, torch.as_tensor(prep["V"], **f32), *(torch.as_tensor(prep[k], **f32) for k in ("s", "wmu", "cv")),
        *rows, **{k: float(np.float32(prep[k])) for k in ("yPy", "logdet_plam", "logdet_ptau")},
        n_obs=float(prep["n_obs"]), a_lam=float(a_lam), b_lam=float(b_lam), a_tau=float(a_tau), b_tau=float(b_tau),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), bit_source=bit_source,
    )


# ---------------------------------------------------------------------------
# constant-metric manifold MALA (kernel K9)
# ---------------------------------------------------------------------------


def prepare_mmala(X, y, tau=1.0, lam=1.0, ptau_diag=None, plam_diag=None, mu0=None, beta0=None):
    """Host preparation of :func:`run_spectral_mmala`, all f64 numpy, as the JAX
    package does it: the pencil of G = X'PX and diag(plam), V' diag(plam) V = I
    and V'GV = diag(s), the metric eigenvalues ``d`` = tau s + lam, ``vw`` = V'v
    with v = tau X'Py + lam plam mu0, ``w0`` = V' plam beta0, and ``yPy`` =
    tau y'Py + lam mu0'Plam mu0, ``logdet_tauP``, ``logdet_lamPlam``,
    ``half_logdetA`` = 1/2 sum log d, ``n_obs``."""
    X = _f64(X)
    y = _f64(y).reshape(-1)
    n_obs, p = X.shape
    if p > MAX_P:
        raise ValueError(f"spectral mMALA supports p <= {MAX_P}, got {p}")
    ptau = np.ones(n_obs) if ptau_diag is None else _f64(ptau_diag).reshape(-1)
    plam = np.ones(p) if plam_diag is None else _f64(plam_diag).reshape(-1)
    mu0 = np.zeros(p) if mu0 is None else _f64(mu0).reshape(-1)
    beta0 = np.zeros(p) if beta0 is None else _f64(beta0).reshape(-1)
    XtP = X.T * ptau[None, :]
    V, s = _eigenbasis(XtP @ X, plam)
    d = tau * s + lam
    v = tau * (XtP @ y) + lam * plam * mu0
    return {
        "V": V, "d": d, "vw": V.T @ v, "w0": V.T @ (plam * beta0),
        "yPy": float(tau * np.sum(y * ptau * y) + lam * np.sum(mu0 * plam * mu0)),
        "logdet_tauP": float(n_obs * np.log(tau) + np.sum(np.log(ptau))),
        "logdet_lamPlam": float(p * np.log(lam) + np.sum(np.log(plam))),
        "half_logdetA": float(0.5 * np.sum(np.log(d))), "n_obs": n_obs,
    }


def mmala_step_constants(p: int, step: float) -> dict:
    """The float32 constants of a fixed (not adapted) step, folded on the host in
    float64 as the JAX kernel folds them: s, s^2, s^2/2 and p/2 (log 2 pi + log s^2)."""
    s2 = step * step
    return {"step": step, "s2": s2, "c_pull": 0.5 * s2, "c_norm": 0.5 * p * (prng.LOG_2PI + math.log(s2))}


@profiling.traced("kernel.spectral_mmala")
def spectral_mmala_sweeps_plain(seed, V, d, cw, isd, w0, n_chains, *, log_const, half_logdetA, step, adapt,
                                target, rate, n_burn, n_keep, n_thin=1, bit_source=None):
    """Plain PyTorch version of the K9 kernel: all sweeps for all chains.

    ``V`` is the (p, p) float32 eigenbasis (beta rows); ``d`` and ``w0`` are (p,)
    as :func:`prepare_mmala` gives them, ``cw`` = vw / d (the posterior mean in
    w) and ``isd`` = rsqrt(d), computed once by the caller so that kernel and
    plain version read the same values; ``log_const`` and ``half_logdetA``
    float32 values (:func:`mmala_inputs`). In w = V^-1 beta every step is
    elementwise:

        mu(w) = w + s^2/2 (cw - w),   w' = mu(w) + s z / sqrt(d),
        log pi(w) = log_const - 1/2 sum d (w - cw)^2,
        log q(x | m) = 1/2 sum log d - p/2 (log 2 pi + log s^2) - sum d (x - m)^2 / (2 s^2),

    with the three sums in K5's fixed window order (:func:`window_sums`); with
    ``adapt`` a per-chain log step, nudged during burn-in. Draws come from
    Philox unless ``bit_source(sweep, site, shape)`` supplies them (CPU tensors
    only). Returns ``beta`` (chains, n_keep, p), ``log_post``/``accept``
    (chains, n_keep) and ``accept_total``/``log_step`` (chains,)."""
    device = V.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    p = V.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    dv, cw, isd, w0 = (torch.as_tensor(t, **f32)[None, :] for t in (d, cw, isd, w0))
    const, half_logdet = torch.tensor(log_const, **f32), torch.tensor(half_logdetA, **f32)
    fixed = mmala_step_constants(p, step)
    w = torch.zeros((n_chains, p), **f32) + w0
    r = w - cw
    lp = const - 0.5 * window_sums((dv * r * r)[:, None, :])[:, 0]
    acc = torch.zeros(n_chains, **f32)
    log_step = torch.full((n_chains,), math.log(step), **f32)
    out_b = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("log_post", "accept")}
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, [p, 1], device)
        else:
            sites = [bit_source(it, k, (n_chains, width)) for k, width in enumerate((p, 1))]
        if adapt:
            step_v = torch.exp(log_step)
            s2 = step_v * step_v
            c_pull = 0.5 * s2
            c_norm = 0.5 * p * (prng.LOG_2PI + 2.0 * log_step)
            step_v, c_pull = step_v[:, None], c_pull[:, None]
        else:
            step_v, s2, c_pull, c_norm = (fixed[k] for k in ("step", "s2", "c_pull", "c_norm"))
        z = prng.normal_icdf((n_chains, p), lambda shape: sites[0])
        mu_cur = w + c_pull * (cw - w)
        w_prop = mu_cur + step_v * z * isd
        r_tgt = w_prop - cw
        r_fwd = w - (w_prop + c_pull * (cw - w_prop))
        r_rev = w_prop - mu_cur
        sums = window_sums(torch.stack([dv * r_tgt * r_tgt, dv * r_fwd * r_fwd, dv * r_rev * r_rev], dim=1))
        lp_prop = const - 0.5 * sums[:, 0]
        q_fwd = half_logdet - c_norm - 0.5 * sums[:, 1] / s2
        q_rev = half_logdet - c_norm - 0.5 * sums[:, 2] / s2
        log_accept = lp_prop - lp + q_fwd - q_rev
        accept = torch.log(prng.uniform((n_chains, 1), lambda shape: sites[1])[:, 0]) < log_accept
        w = torch.where(accept[:, None], w_prop, w)
        lp = torch.where(accept, lp_prop, lp)
        acc = acc + accept.to(torch.float32)
        if adapt and it < n_burn:
            alpha = torch.exp(torch.clamp(log_accept, max=0.0))
            log_step = log_step + rate * (alpha - target)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        out_b[:, idx] = spectral_store_plain(w, V)
        out["log_post"][:, idx] = lp
        out["accept"][:, idx] = accept.to(torch.float32)
    return {"beta": out_b, **out, "accept_total": acc, "log_step": log_step}


class MmalaWideParams(ctypes.Structure):
    """Mirror of ``struct MmalaWideParams`` in ``csrc/spectral_mmala.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("sum_windows", ctypes.c_int32),
        ("sum_lo", ctypes.c_int32),
        ("adapt", ctypes.c_int32),
        ("log_const", ctypes.c_float),
        ("half_logdetA", ctypes.c_float),
        ("half_p", ctypes.c_float),
        ("log_step0", ctypes.c_float),
        ("step", ctypes.c_float),
        ("s2", ctypes.c_float),
        ("c_pull", ctypes.c_float),
        ("c_norm", ctypes.c_float),
        ("target", ctypes.c_float),
        ("rate", ctypes.c_float),
    ]


def _check_mmala_inputs(V, vectors: dict, n_chains):
    p = V.shape[0]
    if V.dim() != 2 or V.shape[1] != p or p > MAX_P:
        raise ValueError(f"V must be (p, p) with p <= {MAX_P}, got {tuple(V.shape)}")
    if n_chains < 1:
        raise ValueError("need n_chains >= 1")
    for name, t in (("V", V), *vectors.items()):
        if name != "V" and tuple(t.shape) != (p,):
            raise ValueError(f"{name} must have shape ({p},), got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != V.device:
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {V.device}")


@profiling.traced("kernel.spectral_mmala")
def spectral_mmala_sweeps_kernel(seed, V, d, cw, isd, w0, n_chains, *, log_const, half_logdetA, step, adapt,
                                 target, rate, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/spectral_mmala.cu`` on CUDA tensors (arguments and results
    as :func:`spectral_mmala_sweeps_plain`), which writes each stored sweep's w
    into beta's row, then :func:`spectral_store_kernel` over the rows. Both
    launch on the current stream; nothing synchronises."""
    _check_mmala_inputs(V, {"d": d, "cw": cw, "isd": isd, "w0": w0}, n_chains)
    if V.device.type != "cuda":
        raise ValueError(f"spectral mMALA kernel: expected CUDA tensors, got {V.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    p = V.shape[0]
    n_win, lo = sum_windows(p)
    prm = MmalaWideParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn,
        n_thin=n_thin, n_keep=n_keep, sum_windows=n_win, sum_lo=lo, adapt=int(bool(adapt)), log_const=log_const,
        half_logdetA=half_logdetA, half_p=0.5 * p, log_step0=math.log(step), target=target, rate=rate,
        **mmala_step_constants(p, step),
    )
    out_b = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=V.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=V.device) for k in ("log_post", "accept")}
    last = {k: torch.empty((n_chains,), dtype=torch.float32, device=V.device) for k in ("accept_total", "log_step")}
    lib = _build.library()
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream(V.device).cuda_stream
        err = lib.spectral_mmala_launch(
            ctypes.byref(prm), d.data_ptr(), cw.data_ptr(), isd.data_ptr(), w0.data_ptr(), out_b.data_ptr(),
            out["log_post"].data_ptr(), out["accept"].data_ptr(), last["accept_total"].data_ptr(),
            last["log_step"].data_ptr(), stream,
        )
    profiling.count("launch.spectral_mmala")
    _build.check(err, "spectral_mmala")
    spectral_store_kernel(out_b, V)
    return {"beta": out_b, **out, **last}


def spectral_mmala_sweeps(seed, V, d, cw, isd, w0, n_chains, *, bit_source=None, **kw):
    """All sweeps for all chains: the K9 kernel for CUDA tensors, the plain
    version for CPU tensors. A CUDA call launches the kernel or raises."""
    if V.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return spectral_mmala_sweeps_kernel(seed, V, d, cw, isd, w0, n_chains, **kw)
    if V.device.type != "cpu":
        raise ValueError(f"spectral mMALA: unsupported device {V.device}")
    _check_mmala_inputs(V, {"d": d, "cw": cw, "isd": isd, "w0": w0}, n_chains)
    return spectral_mmala_sweeps_plain(seed, V, d, cw, isd, w0, n_chains, bit_source=bit_source, **kw)


def mmala_inputs(prep: dict, device):
    """The K9 tensors of a :func:`prepare_mmala` result on ``device``: V, d,
    cw = vw / d, isd = rsqrt(d) and w0 (float32), and the scalar keywords: the
    log target's constant at its mode, log_const = 1/2 (logdet(tau P) - N log 2 pi)
    + 1/2 (logdet(lam Plam) - p log 2 pi) + 1/2 (sum vw^2 / d - yPy), taken in
    float64, and half_logdetA."""
    f32 = dict(dtype=torch.float32, device=device)
    V, d, vw, w0 = (torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "d", "vw", "w0"))
    p, n_obs = prep["V"].shape[0], prep["n_obs"]
    log_const = (0.5 * (prep["logdet_tauP"] - n_obs * prng.LOG_2PI) + 0.5 * (prep["logdet_lamPlam"] - p * prng.LOG_2PI)
                 + 0.5 * (float(np.sum(prep["vw"] ** 2 / prep["d"])) - prep["yPy"]))
    kw = {"log_const": float(np.float32(log_const)), "half_logdetA": float(np.float32(prep["half_logdetA"]))}
    return (V, d, vw / d, torch.rsqrt(d), w0), kw


def run_spectral_mmala(
    seed, X, y, n_burn, n_iter, n_chains, tau=1.0, lam=1.0, step=1.0, ptau_diag=None, plam_diag=None, mu0=None,
    beta0=None, adapt_step=False, target_accept=0.574, adapt_rate=0.05, n_thin=1, device="cuda", bit_source=None,
):
    """Constant-metric manifold MALA, p <= 256, the whole run in one launch.

    Model, arguments and results as :func:`openmcmc_tpu_torch.fused.mmala.
    run_fused_mmala`; the host diagonalizes the metric A = tau G + lam diag(plam)
    once in float64, so every proposal and accept is elementwise in
    eigencoordinates. ``device`` is the card unless the caller asks for the
    CPU; ``bit_source(sweep, site, shape)`` replaces Philox (CPU only)."""
    prep = prepare_mmala(X, y, tau=tau, lam=lam, ptau_diag=ptau_diag, plam_diag=plam_diag, mu0=mu0, beta0=beta0)
    tensors, kw = mmala_inputs(prep, torch.device(device))
    return spectral_mmala_sweeps(
        seed, *tensors, int(n_chains), **kw, step=float(step), adapt=bool(adapt_step), target=float(target_accept),
        rate=float(adapt_rate), n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), bit_source=bit_source,
    )
