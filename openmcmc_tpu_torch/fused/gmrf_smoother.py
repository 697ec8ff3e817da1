"""Thomas-scan GMRF smoother: the whole Gibbs run, every chain, one launch (kernel K4).

Port of ``openmcmc_tpu/fused/gmrf_smoother.py`` (``run_fused_smoother`` :271,
kernel ``_make_kernel`` :58). Model: y ~ N(b, (tau D)^-1), b ~ N(mu0, (lam P0)^-1)
with a tridiagonal P0, Gamma priors on lam and tau. Each sweep redraws b
exactly through a Thomas factorisation of Q = lam P0 + tau D, or -- with a
box-truncated latent prior -- takes one red-black truncated Gibbs sweep over
the carried b (the generic driver's banded schedule, with the reference's
unrenormalised truncation, so the Gamma conditionals and log_post keep their
untruncated forms). Then lam and tau are two single Marsaglia-Tsang draws.

:func:`gmrf_smoother` runs all sweeps for all chains: on CUDA tensors it
launches ``csrc/gmrf_smoother.cu``, on CPU tensors it takes
:func:`gmrf_smoother_plain`, the same sweep as a Python loop over sweeps
vectorised over chains. Bits as in :mod:`openmcmc_tpu_torch.fused.prng`: site 0
is the Thomas variant's p normals; sites 0 and 1 the truncated variant's even
and odd colour uniforms, each over all p rows; then lam's rounds, then tau's.

Not ported, because they exist for the TPU only: the padding of p to a multiple
of CHUNK and its row mask (P0's last off-diagonal entry is never read as a
coupling, so padding rows never met the real ones), the BLOCK_B lane blocks and
the double-buffered store DMAs. A resume (``init=``) feeds the kernel
per-chain ``lam0``/``tau0`` rows and, truncated, a per-chain ``b_init``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import chain_rows, store_index
from openmcmc_tpu_torch.fused.spectral import _lgam
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.utils import profiling

OPEN_BOUND = 1e30  # an open side of the box, as the JAX package passes it


def _specs(a_lam_star: float, a_tau_star: float, truncated: bool):
    """The two Gamma specs and the element count of every draw site of a sweep."""
    n_wide = 2 if truncated else 1
    g_lam = prng._single_spec(a_lam_star, n_wide)
    n_lam = 2 * g_lam.rounds + g_lam.boost
    g_tau = prng._single_spec(a_tau_star, n_wide + n_lam)
    n_tau = 2 * g_tau.rounds + g_tau.boost
    return g_lam, g_tau, n_wide, n_lam + n_tau


def _row_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum (chains, k, p) terms over the last axis one row at a time, in
    ascending order, as the kernel sums: the prior's quadratic form cancels
    heavily, so torch.sum's order would move lam by far more than the rest of
    the sweep's float32 rounding does. Returns (chains, k)."""
    acc = torch.zeros_like(terms[:, :, 0])
    for t in terms.unbind(2):
        acc = acc + t
    return acc


@profiling.traced("kernel.gmrf_smoother")
def gmrf_smoother_plain(seed, p0d, p0c, y, d, mu, p0mu, lam0, tau0, *, lo=None, hi=None, b_init=None,
                        logdet_p0, logdet_d, a_lam, b_lam, a_tau, b_tau, n_burn, n_keep, n_thin=1,
                        bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``p0d``/``p0c`` are P0's diagonal and off-diagonal, ``y``, ``d`` (the noise
    diagonal), ``mu`` (mu0) and ``p0mu`` (P0 mu0) are (p,); ``lam0``/``tau0`` are
    (chains,). Passing ``lo``/``hi`` (p,) selects the truncated variant, whose
    carried latent starts at ``b_init`` (chains, p). ``n_burn`` counts burn-in
    SWEEPS, ``n_keep`` stored draws, each after ``n_thin`` sweeps. Draws come
    from Philox (the kernel's bits) unless ``bit_source(sweep, site, shape)``
    supplies them (CPU tensors only). Returns ``b`` (chains, n_keep, p) and
    ``lam``/``tau``/``log_post`` (chains, n_keep)."""
    device = y.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    truncated = lo is not None
    n_chains, p = lam0.shape[0], y.shape[0]
    p_real = float(p)
    a_lam_star, a_tau_star = a_lam + 0.5 * p_real, a_tau + 0.5 * p_real
    lgam_lam, lgam_tau = _lgam(a_lam, b_lam), _lgam(a_tau, b_tau)
    _, _, n_wide, n_gamma = _specs(a_lam_star, a_tau_star, truncated)
    widths = [p] * n_wide + [1] * n_gamma
    f32 = dict(dtype=torch.float32, device=device)
    P0d, P0c, Y, D, MU, P0MU = (torch.as_tensor(v, **f32)[None, :] for v in (p0d, p0c, y, d, mu, p0mu))
    P0c_prev = F.pad(P0c[:, :-1], (1, 0))
    ld_p0, ld_d = torch.tensor(logdet_p0, **f32), torch.tensor(logdet_d, **f32)
    out_b = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("lam", "tau", "log_post")}
    lam, tau = lam0.to(**f32).reshape(-1, 1), tau0.to(**f32).reshape(-1, 1)
    if truncated:
        LO, HI = (torch.as_tensor(v, **f32)[None, :] for v in (lo, hi))
        x = b_init.to(**f32).expand(n_chains, p).clone()
        even = (torch.arange(p, device=device) % 2 == 0)[None, :]
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(widths)]
        draw = prng.SiteStream(sites)
        rhs = tau * (D * Y) + lam * P0MU
        qd = lam * P0d + tau * D
        if truncated:
            # one red-black sweep: the odd rows condition on the even rows' new values
            sd = torch.rsqrt(qd)
            for sel in (even, ~even):
                up = F.pad(x[:, 1:], (0, 1))
                down = F.pad((P0c * x)[:, :-1], (1, 0))
                cond = (rhs - lam * (P0c * up + down)) / qd
                z = prng.truncnorm_draw(cond, sd, LO, HI, (n_chains, p), draw)
                x = torch.where(sel, z, x)
            b = x
        else:
            # only the recurrences loop over rows; the elementwise steps off them
            # (the noise, the back pass's coefficients) run on all rows at once
            z = prng.normal_icdf((n_chains, p), draw)
            ld_prev = torch.ones((n_chains,), **f32)
            w_prev = torch.zeros((n_chains,), **f32)
            ld_rows, w_rows = [], []
            for cp_i, qd_i, rhs_i in zip((lam * P0c_prev).unbind(1), qd.unbind(1), rhs.unbind(1)):
                l_prev = cp_i / ld_prev
                ld = torch.sqrt(qd_i - l_prev * l_prev)
                w = (rhs_i - l_prev * w_prev) / ld
                ld_rows.append(ld)
                w_rows.append(w)
                ld_prev, w_prev = ld, w
            ld_all = torch.stack(ld_rows, dim=1)
            u = torch.stack(w_rows, dim=1) + z
            coef = (lam * P0c) / ld_all
            x_next = torch.zeros((n_chains,), **f32)
            rows = []  # last row first
            for u_i, coef_i, ld_i in zip(*(t.unbind(1)[::-1] for t in (u, coef, ld_all))):
                x_next = (u_i - coef_i * x_next) / ld_i
                rows.append(x_next)
            b = torch.stack(rows[::-1], dim=1)
        # NormalGamma: lam | b, then tau | b, y
        r = b - MU
        p0r = P0d * r + P0c * F.pad(r[:, 1:], (0, 1)) + F.pad((P0c * r)[:, :-1], (1, 0))
        resid = Y - b
        quads = _row_sum(torch.stack([r * p0r, D * resid * resid], dim=1))
        quad_lam, quad_tau = quads[:, 0:1], quads[:, 1:2]
        lam = prng.gamma_mt(a_lam_star, b_lam + 0.5 * quad_lam, draw)
        tau = prng.gamma_mt(a_tau_star, b_tau + 0.5 * quad_tau, draw)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        log_like = 0.5 * (p_real * torch.log(tau) + ld_d - p_real * prng.LOG_2PI - tau * quad_tau)
        log_prior_b = 0.5 * (p_real * torch.log(lam) + ld_p0 - p_real * prng.LOG_2PI - lam * quad_lam)
        log_lam = lgam_lam + (a_lam - 1.0) * torch.log(lam) - b_lam * lam
        log_tau = lgam_tau + (a_tau - 1.0) * torch.log(tau) - b_tau * tau
        out_b[:, idx] = b
        out["lam"][:, idx] = lam[:, 0]
        out["tau"][:, idx] = tau[:, 0]
        out["log_post"][:, idx] = (log_like + log_prior_b + log_lam + log_tau)[:, 0]
    return {"b": out_b, **out}


class GmrfParams(ctypes.Structure):
    """Mirror of ``struct GmrfParams`` in ``csrc/gmrf_smoother.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("truncated", ctypes.c_int32),
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


def _check_inputs(p0d, p0c, y, d, mu, p0mu, lam0, tau0, lo, hi, b_init):
    p = y.shape[0] if y.dim() == 1 else -1
    if p < 1:
        raise ValueError(f"y must be a non-empty (p,) tensor, got {tuple(y.shape)}")
    if lam0.dim() != 1 or lam0.shape[0] < 1:
        raise ValueError("lam0 must be a non-empty (chains,) tensor")
    if (lo is None) != (hi is None) or (lo is None) != (b_init is None):
        raise ValueError("the truncated variant needs lo, hi and b_init together")
    n_chains = lam0.shape[0]
    named = {"p0d": (p0d, (p,)), "p0c": (p0c, (p,)), "d": (d, (p,)), "mu": (mu, (p,)), "p0mu": (p0mu, (p,)),
             "lam0": (lam0, (n_chains,)), "tau0": (tau0, (n_chains,)), "y": (y, (p,))}
    if lo is not None:
        named.update(lo=(lo, (p,)), hi=(hi, (p,)), b_init=(b_init, (n_chains, p)))
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != y.device:
            raise ValueError(f"{name}: expected a float32 tensor on {y.device}")


@profiling.traced("kernel.gmrf_smoother")
def gmrf_smoother_kernel(seed, p0d, p0c, y, d, mu, p0mu, lam0, tau0, *, lo=None, hi=None, b_init=None,
                         logdet_p0, logdet_d, a_lam, b_lam, a_tau, b_tau, n_burn, n_keep, n_thin=1):
    """Launch ``csrc/gmrf_smoother.cu`` on CUDA tensors (arguments and results
    as :func:`gmrf_smoother_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(p0d, p0c, y, d, mu, p0mu, lam0, tau0, lo, hi, b_init)
    if y.device.type != "cuda":
        raise ValueError(f"Thomas smoother kernel: expected CUDA tensors, got {y.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    n_chains, p = lam0.shape[0], y.shape[0]
    n_sweeps = n_burn + n_keep * n_thin
    if n_chains > 2**31 - 1 or n_sweeps > 2**31 - 1:
        raise ValueError("chains and sweeps must fit int32")
    truncated = lo is not None
    p_real = float(p)
    g_lam, g_tau, _, _ = _specs(a_lam + 0.5 * p_real, a_tau + 0.5 * p_real, truncated)
    prm = GmrfParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_sweeps, n_burn=n_burn, n_thin=n_thin,
        n_keep=n_keep, truncated=int(truncated), b_lam=b_lam, b_tau=b_tau, p_real=p_real,
        p_log2pi=p_real * prng.LOG_2PI, logdet_p0=logdet_p0, logdet_d=logdet_d, lgam_lam=_lgam(a_lam, b_lam),
        lgam_tau=_lgam(a_tau, b_tau), a_lam_m1=a_lam - 1.0, a_tau_m1=a_tau - 1.0, g_lam=g_lam, g_tau=g_tau,
    )
    vecs = [t.contiguous() for t in (p0d, p0c, y, d, mu, p0mu)]
    lam0, tau0 = lam0.contiguous(), tau0.contiguous()
    if truncated:
        lo, hi = lo.contiguous(), hi.contiguous()
        s1 = b_init.contiguous().clone()  # (chains, p): the carried x, seeded with b_init
        s2 = s1
    else:
        # (p, chains rounded up to the kernel's 32 chains a block): ld, and u then x
        s1 = torch.empty((p, -(-n_chains // 32) * 32), dtype=torch.float32, device=y.device)
        s2 = torch.empty_like(s1)
    out_b = torch.empty((n_chains, n_keep, p), dtype=torch.float32, device=y.device)
    out = {k: torch.empty((n_chains, n_keep), dtype=torch.float32, device=y.device)
           for k in ("lam", "tau", "log_post")}
    lib = _build.library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.gmrf_smoother_launch(
            ctypes.byref(prm), *(t.data_ptr() for t in vecs), lo.data_ptr() if truncated else None,
            hi.data_ptr() if truncated else None, lam0.data_ptr(), tau0.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            out_b.data_ptr(), out["lam"].data_ptr(), out["tau"].data_ptr(), out["log_post"].data_ptr(), stream,
        )
    profiling.count("launch.gmrf_smoother")
    _build.check(err, "gmrf_smoother")
    return {"b": out_b, **out}


def gmrf_smoother(seed, p0d, p0c, y, d, mu, p0mu, lam0, tau0, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU tensors. A CUDA call launches the kernel or raises."""
    if y.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return gmrf_smoother_kernel(seed, p0d, p0c, y, d, mu, p0mu, lam0, tau0, **kw)
    if y.device.type != "cpu":
        raise ValueError(f"Thomas smoother: unsupported device {y.device}")
    _check_inputs(p0d, p0c, y, d, mu, p0mu, lam0, tau0, kw.get("lo"), kw.get("hi"), kw.get("b_init"))
    return gmrf_smoother_plain(seed, p0d, p0c, y, d, mu, p0mu, lam0, tau0, bit_source=bit_source, **kw)


def _tensor(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))
    return t.to(device=device, dtype=torch.float32)


def _vector(v, device) -> torch.Tensor:
    return _tensor(v, device).reshape(-1)


def prepare(y, s=None, ridge=0.001, P0_bands=None, noise_diag=None, mu0=None, lower=None, upper=None,
            b_init=None, device="cuda"):
    """Host preparation of :func:`run_fused_smoother`: P0's bands (``P0_bands``,
    or the RW1 precision of ``s`` with ``ridge`` added to its first diagonal
    entry), y, the noise diagonal D (default ones), mu0 (default zeros) and
    P0 mu0 as (p,) float32 tensors on ``device`` (the card unless the caller
    asks for the CPU); ``logdet_p0`` by the clamped
    structured Cholesky and ``logdet_d``; and, when a bound is given, the box
    (+-1e30 for an open side) and the initial latent clipped into it (y unless
    ``b_init``, (p,) or (chains, p), is given)."""
    y = _vector(y, device)
    p = y.shape[0]
    if P0_bands is not None:
        bands = _tensor(P0_bands, device).reshape(2, p)
    else:
        bands = gmrf.precision_irregular(_vector(s, device)).bands.clone()
        bands[0, 0] = bands[0, 0] + ridge
    P0 = st.Banded(bands)
    d = torch.ones(p, dtype=torch.float32, device=device) if noise_diag is None else _vector(noise_diag, device)
    mu = torch.zeros(p, dtype=torch.float32, device=device) if mu0 is None else _vector(mu0, device)
    prep = {
        "p0d": bands[0].contiguous(), "p0c": bands[1].contiguous(), "y": y, "d": d, "mu": mu,
        "p0mu": st.matvec(P0, mu), "logdet_p0": st.host_log_det(P0),
        "logdet_d": float(torch.sum(torch.log(d.cpu()))),
    }
    if lower is not None or upper is not None:
        lo = _vector(-OPEN_BOUND if lower is None else lower, device).expand(p).contiguous()
        hi = _vector(OPEN_BOUND if upper is None else upper, device).expand(p).contiguous()
        start = y if b_init is None else _tensor(b_init, device)
        prep.update(lo=lo, hi=hi, b_init=torch.clamp(start, lo, hi))
    return prep


def run_fused_smoother(
    seed, y, s, n_burn, n_iter, n_chains,
    a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, lam0=100.0, tau0=1.0, ridge=0.001,
    P0_bands=None, noise_diag=None, mu0=None, n_thin=1, lower=None, upper=None, b_init=None, init=None,
    device="cuda", bit_source=None,
):
    """The GMRF smoother with a tridiagonal prior precision, any p, one launch.

    Arguments as the JAX package's ``run_fused_smoother``: y (p,) observed at
    locations ``s``, P0 the RW1 precision of ``s`` plus ``ridge`` on its first
    diagonal entry, or ``P0_bands`` (2, p) given directly; ``noise_diag`` the
    noise penalty diagonal D (default ones), ``mu0`` the prior mean (default
    zeros). ``lower``/``upper`` (scalars or (p,); +-1e30 for an open side)
    box-truncate the latent prior, which selects the truncated variant; its
    carried latent starts at ``b_init`` ((p,) shared or (chains, p)) clipped
    into the box, by default y clipped. ``n_burn`` is the burn-in SWEEP count,
    ``n_iter`` the stored draws, each after ``n_thin`` sweeps; ``lam0``/``tau0``
    are scalars or per-chain (chains,) values. ``init``, the warm start of a
    resume, is a dict of per-chain ``lam`` and ``tau`` (chains,) and, in the
    truncated variant, the carried latent ``b`` (chains, p), which replace
    lam0, tau0 and b_init. ``device`` is the card unless
    the caller asks for the CPU; ``bit_source(sweep, site, shape)`` replaces
    Philox (CPU only). Returns ``b`` (chains, n_iter, p) and
    ``lam``/``tau``/``log_post`` (chains, n_iter)."""
    device = torch.device(device)
    if init is not None and "b" in init:
        b_init = torch.as_tensor(init["b"]).reshape(n_chains, -1)
    prep = prepare(y, s, ridge=ridge, P0_bands=P0_bands, noise_diag=noise_diag, mu0=mu0, lower=lower,
                   upper=upper, b_init=b_init, device=device)
    p = prep["y"].shape[0]
    rows = chain_rows(n_chains, lam0, tau0, init, device)
    kw = {}
    if "lo" in prep:
        kw = dict(lo=prep["lo"], hi=prep["hi"], b_init=prep["b_init"].expand(n_chains, p).contiguous())
    return gmrf_smoother(
        seed, *(prep[k] for k in ("p0d", "p0c", "y", "d", "mu", "p0mu")), *rows, bit_source=bit_source,
        logdet_p0=prep["logdet_p0"], logdet_d=prep["logdet_d"],
        a_lam=float(a_lam), b_lam=float(b_lam), a_tau=float(a_tau), b_tau=float(b_tau),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), **kw,
    )
