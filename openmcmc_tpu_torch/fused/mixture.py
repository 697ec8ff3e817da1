"""The Gaussian-mixture Gibbs run in one launch (kernel K10).

Port of ``openmcmc_tpu/fused/mixture.py`` (``run_fused_mixture`` :465, kernel
``_make_kernel`` :107). Model, K <= 32 components, n <= 2^20 points with r
replicate columns that share each point's allocation:

    y_ij ~ N(mu_{Z_i}, 1 / lam_{Z_i}),   Z_i ~ Categorical(w_i.),
    mu ~ N(mu0, diag(p0)^-1),            lam_k ~ Gamma(a0_k, b0_k),

swept as [allocation, means, precisions]: every point's allocation by inverse
CDF (one uniform per point), then a joint (truncated) random-walk step on the
means or their conjugate draw (``conjugate_means``), then the K Gamma draws.
Given the allocation everything downstream reads the per-component sufficient
statistics S0 = #observations, S1 = sum y, S2 = sum y^2 and S3 = sum log w,
which need only the per-point replicate summaries: the host packs the data as
columns [count | sum | sum of squares | log w_1..K].

:func:`mixture_sweeps` runs all sweeps for all chains: on CUDA tensors it
launches ``csrc/mixture.cu``, on CPU tensors it takes
:func:`mixture_sweeps_plain`, the same sweep as a Python loop over sweeps
vectorised over chains and points. Kernel and plain version add S0..S3 in one
order (the statistics feed discrete allocations, and quad = S2 - 2 mu S1 +
S0 mu^2 cancels): thread t of a block of T threads takes the points
4 (r T + t) + j, j = 0..3, in ascending order into its own partial sums, then
the T partials meet in a halving tree, ``x = x[:h] + x[h:]``. T is the power of
two in [32, 256] nearest above n / 4 (:func:`block_threads`).

Bits as in :mod:`openmcmc_tpu_torch.fused.prng`, counter (chain, sweep, site,
j / 4): site 0 holds the n allocation uniforms (j = point); with the random walk
site 1 holds the K proposal normals (or truncated-draw uniforms) and site 2 the
accept uniform; with conjugate means site 1 holds the K normals; then the six
``gamma_mt_elem`` rounds, a (normal, uniform) pair of sites over K each.

Not ported, because they exist for the TPU only: the lane blocks, the
``RESIDENT_N``/``TILE_N`` split with its DMA double-buffering and ``UNROLL``,
and the sublane padding. Resume (``init=``) is not ported yet (ROADMAP.md queue
1: operations).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import store_index

MAX_K = 32
MAX_N = 1 << 20
MAX_THREADS = 256
N_SCAL = 9  # scal rows: mu0, p0, a0, b0, mu_init, lam_init, lb, ub, lgam


def block_threads(n: int) -> int:
    """Threads per chain: the power of two in [32, 256] at or above n / 4 (each
    thread takes groups of 4 points, one Philox block each)."""
    groups = max(1, (n + 3) // 4)
    return min(MAX_THREADS, max(32, 1 << (groups - 1).bit_length()))


def site_widths(n: int, k_comp: int, conjugate: bool):
    """Element count of each draw site of one sweep, in order."""
    head = [n, k_comp] if conjugate else [n, k_comp, 1]
    return head + [k_comp] * (2 * prng.GAMMA_ROUNDS)


def _allocate(data, n, threads, mu, lam, u_bits):
    """The allocation pass of one sweep for all chains: per point, the K
    log-likelihoods in the JAX kernel's operation order, their max, exp weights
    and the inverse-CDF index; then each thread's ascending partial sums of S0..S3
    and the halving tree over threads. Returns the (4, chains, K) statistics and
    the (chains, n) int32 allocation."""
    k_comp = mu.shape[1]
    groups = (n + 3) // 4
    rows = (groups + threads - 1) // threads
    width = 4 * rows * threads
    padded = torch.zeros((data.shape[0], width), dtype=data.dtype, device=data.device)
    padded[:, :n] = data[:, :n]
    view = padded.reshape(-1, rows, threads, 4)  # point 4 (r T + t) + j
    cnt, sm, sq = view[0], view[1], view[2]
    lw = view[3:].permute(1, 2, 3, 0)  # (rows, T, 4, K)
    valid = (torch.arange(width, device=data.device) < n).reshape(rows, threads, 4)

    cl = torch.log(lam) - prng.LOG_2PI
    hlam, mu2 = 0.5 * lam, 2.0 * mu
    e = (slice(None), None, None, None, slice(None))  # (chains, K) -> (chains, 1, 1, 1, K)
    ll = (lw + (0.5 * cnt)[..., None] * cl[e]) - hlam[e] * (
        (sq[..., None] - mu2[e] * sm[..., None]) + (cnt[..., None] * mu[e]) * mu[e])
    w = torch.exp(ll - torch.amax(ll, dim=-1, keepdim=True))
    tot = w[..., 0]
    for k in range(1, k_comp):
        tot = tot + w[..., k]
    bits = torch.zeros((mu.shape[0], width), dtype=torch.int64, device=data.device)
    bits[:, :n] = u_bits
    u = prng.uniform(tuple(bits.shape), lambda shape: bits).reshape(-1, rows, threads, 4) * tot
    cum = w[..., 0]
    z = (u >= cum).to(torch.int32)
    for k in range(1, k_comp - 1):
        cum = cum + w[..., k]
        z = z + (u >= cum).to(torch.int32)

    sel = (z[..., None] == torch.arange(k_comp, device=z.device)) & valid[..., None]  # (chains, rows, T, 4, K)
    vals = (cnt[..., None], sm[..., None], sq[..., None], lw)
    parts = [torch.zeros((mu.shape[0], threads, k_comp), dtype=mu.dtype, device=mu.device) for _ in range(4)]
    for r in range(rows):
        for j in range(4):
            s = sel[:, r, :, j, :]
            for q in range(4):
                parts[q] = parts[q] + torch.where(s, vals[q][r, :, j, :], 0.0)
    stats = torch.stack(parts)  # (4, chains, T, K)
    h = threads // 2
    while h >= 1:
        stats = stats[:, :, :h] + stats[:, :, h:2 * h]
        h //= 2
    return stats[:, :, 0], z.reshape(mu.shape[0], width)[:, :n]


def mixture_sweeps_plain(seed, scal, data, n_chains, *, k_comp, n, threads, conjugate, has_domain, step, n_burn,
                         n_keep, n_thin=1, store_z=False, bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``scal`` is the float32 (9 K,) block [mu0 | p0 | a0 | b0 | mu_init |
    lam_init | lb | ub | lgam] and ``data`` the (3 + K, n4) float32 columns
    [count | sum | sum of squares | log w_1..K] (:func:`prepare`); ``threads``
    is the kernel's T. ``n_burn`` counts burn-in SWEEPS and ``n_keep`` stored
    draws, each after ``n_thin`` sweeps. Draws come from Philox (the kernel's
    bits) unless ``bit_source(sweep, site, shape)`` supplies them (CPU tensors
    only). Returns ``means``/``lams`` (chains, n_keep, K), ``log_post``
    (chains, n_keep), ``accept_total`` (chains,), the means' accepted moves over
    all sweeps, and with ``store_z`` ``z`` (chains, n_keep, n) int32: the
    allocation drawn at the start of each stored sweep."""
    device = scal.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    f32 = dict(dtype=torch.float32, device=device)
    mu0, p0, a0, b0, mu_i, lam_i, lb, ub, lgam = scal.to(**f32).reshape(N_SCAL, k_comp)
    mu = torch.zeros((n_chains, k_comp), **f32) + mu_i
    lam = torch.zeros((n_chains, k_comp), **f32) + lam_i
    acc = torch.zeros(n_chains, **f32)
    stp = torch.full((n_chains, k_comp), step, **f32)
    out = {"means": torch.empty((n_chains, n_keep, k_comp), **f32),
           "lams": torch.empty((n_chains, n_keep, k_comp), **f32),
           "log_post": torch.empty((n_chains, n_keep), **f32)}
    if store_z:
        out["z"] = torch.empty((n_chains, n_keep, n), dtype=torch.int32, device=device)
    widths = site_widths(n, k_comp, conjugate)
    head = len(widths) - 2 * prng.GAMMA_ROUNDS
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(widths)]
        (s0, s1, s2, s3), z = _allocate(data, n, threads, mu, lam, sites[0])
        if conjugate:
            zs = prng.normal_icdf((n_chains, k_comp), lambda shape: sites[1])
            q = p0 + lam * s0
            mu_new = (p0 * mu0 + lam * s1) / q + zs * (1.0 / torch.sqrt(q))
        else:
            if has_domain:
                prop = prng.truncnorm_draw(mu, stp, lb, ub, (n_chains, k_comp), lambda shape: sites[1])
                rev = prng.truncnorm_logpdf(mu, prop, stp, lb, ub)
                fwd = prng.truncnorm_logpdf(prop, mu, stp, lb, ub)
            else:
                prop = mu + stp * prng.normal_icdf((n_chains, k_comp), lambda shape: sites[1])
            lik = (0.5 * lam) * (((s2 - (2.0 * mu) * s1) + (s0 * mu) * mu) - ((s2 - (2.0 * prop) * s1) + (s0 * prop) * prop))
            dm, dz = mu - mu0, prop - mu0
            pri = (0.5 * p0) * (dm * dm - dz * dz)
            delta = torch.zeros(n_chains, **f32)
            for k in range(k_comp):
                if has_domain:
                    delta = delta + rev[:, k]
                    delta = delta - fwd[:, k]
                delta = delta + lik[:, k]
                delta = delta + pri[:, k]
            accept = torch.log(prng.uniform((n_chains, 1), lambda shape: sites[2])[:, 0]) < delta
            mu_new = torch.where(accept[:, None], prop, mu)
            acc = acc + accept.to(torch.float32)
        quad = (s2 - (2.0 * mu_new) * s1) + (s0 * mu_new) * mu_new
        lam_new = prng.gamma_mt_elem(a0 + 0.5 * s0, b0 + 0.5 * quad, prng.SiteStream(sites[head:]))
        log_lam = torch.log(lam_new)
        dm = mu_new - mu0
        terms = ((0.5 * s0) * (log_lam - prng.LOG_2PI), (0.5 * lam_new) * quad, s3,
                 (0.5 * (torch.log(p0) - prng.LOG_2PI)).expand(n_chains, k_comp), (0.5 * p0) * (dm * dm),
                 lgam.expand(n_chains, k_comp), (a0 - 1.0) * log_lam, b0 * lam_new)
        lp = torch.zeros(n_chains, **f32)
        for k in range(k_comp):
            for i, t in enumerate(terms):
                lp = lp - t[:, k] if i in (1, 4, 7) else lp + t[:, k]
        mu, lam = mu_new, lam_new
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        out["means"][:, idx] = mu
        out["lams"][:, idx] = lam
        out["log_post"][:, idx] = lp
        if store_z:
            out["z"][:, idx] = z
    out["accept_total"] = acc
    return out


class MixParams(ctypes.Structure):
    """Mirror of ``struct MixParams`` in ``csrc/mixture.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("n", ctypes.c_int32),
        ("n4", ctypes.c_int32),
        ("k", ctypes.c_int32),
        ("threads", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("conjugate", ctypes.c_int32),
        ("has_domain", ctypes.c_int32),
        ("store_z", ctypes.c_int32),
        ("step", ctypes.c_float),
    ]


def _check_inputs(scal, data, n_chains, k_comp, n, threads):
    if k_comp < 1 or k_comp > MAX_K:
        raise ValueError(f"fused mixture supports 1 <= K <= {MAX_K}, got {k_comp}")
    if n < 1 or n > MAX_N:
        raise ValueError(f"fused mixture supports 1 <= n <= {MAX_N}, got {n}")
    if threads not in (32, 64, 128, 256):
        raise ValueError(f"threads must be a power of two in [32, 256], got {threads}")
    if tuple(scal.shape) != (N_SCAL * k_comp,) or scal.dtype != torch.float32 or not scal.is_contiguous():
        raise ValueError(f"scal must be a contiguous float32 ({N_SCAL * k_comp},) tensor")
    n4 = n + (-n) % 4
    if tuple(data.shape) != (3 + k_comp, n4) or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError(f"data must be a contiguous float32 ({3 + k_comp}, {n4}) tensor, got {tuple(data.shape)}")
    if data.device != scal.device:
        raise ValueError("scal and data must be on one device")
    if n_chains < 1:
        raise ValueError("need n_chains >= 1")


def mixture_sweeps_kernel(seed, scal, data, n_chains, *, k_comp, n, threads, conjugate, has_domain, step, n_burn,
                          n_keep, n_thin=1, store_z=False):
    """Launch ``csrc/mixture.cu`` on CUDA ``scal`` and ``data`` (arguments and
    results as :func:`mixture_sweeps_plain`). Launches on the current stream,
    does not synchronise."""
    _check_inputs(scal, data, n_chains, k_comp, n, threads)
    if scal.device.type != "cuda":
        raise ValueError(f"mixture kernel: expected CUDA tensors, got {scal.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    prm = MixParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, n=n, n4=data.shape[1], k=k_comp, threads=threads,
        n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn, n_thin=n_thin, n_keep=n_keep, conjugate=int(bool(conjugate)),
        has_domain=int(bool(has_domain)), store_z=int(bool(store_z)), step=step,
    )
    f32 = dict(dtype=torch.float32, device=scal.device)
    out = {"means": torch.empty((n_chains, n_keep, k_comp), **f32),
           "lams": torch.empty((n_chains, n_keep, k_comp), **f32),
           "log_post": torch.empty((n_chains, n_keep), **f32),
           "accept_total": torch.empty((n_chains,), **f32)}
    z = torch.empty((n_chains, n_keep, n) if store_z else (1,), dtype=torch.int32, device=scal.device)
    lib = _build.library()
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream(scal.device).cuda_stream
        err = lib.mixture_launch(
            ctypes.byref(prm), scal.data_ptr(), data.data_ptr(), out["means"].data_ptr(), out["lams"].data_ptr(),
            out["log_post"].data_ptr(), out["accept_total"].data_ptr(), z.data_ptr(), stream,
        )
    mixture_sweeps_kernel.launches += 1
    _build.check(err, "mixture")
    if store_z:
        out["z"] = z
    return out


mixture_sweeps_kernel.launches = 0


def mixture_sweeps(seed, scal, data, n_chains, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU ones. A CUDA call launches the kernel or raises."""
    if scal.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return mixture_sweeps_kernel(seed, scal, data, n_chains, **kw)
    if scal.device.type != "cpu":
        raise ValueError(f"mixture: unsupported device {scal.device}")
    _check_inputs(scal, data, n_chains, kw["k_comp"], kw["n"], kw["threads"])
    return mixture_sweeps_plain(seed, scal, data, n_chains, bit_source=bit_source, **kw)


def _host(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float64)


def prepare(y, prior, mu0, p0, a0, b0, mu_init, lam_init, domain=None, device="cuda"):
    """The kernel's inputs on ``device``: the float32 ``scal`` block and the
    (3 + K, n4) float32 ``data`` columns, packed in float64 on the host as the
    JAX package packs them (the replicate columns of y collapse to per-point
    count, sum and sum of squares; lgam = a0 log b0 - lgamma(a0)); and the
    keywords ``k_comp``, ``n``, ``threads`` and ``has_domain``."""
    y = _host(y)
    if y.ndim == 1:
        y = y[:, None]
    prior = _host(prior)
    n, k_comp = prior.shape
    if y.shape[0] != n:
        raise ValueError(f"y has {y.shape[0]} rows but prior has {n}")
    if k_comp > MAX_K:
        raise ValueError(f"fused mixture supports K <= {MAX_K}, got {k_comp}")
    if n > MAX_N:
        raise ValueError(f"fused mixture supports n <= {MAX_N}, got {n}")

    def vec(v):
        return np.broadcast_to(_host(v).reshape(-1), (k_comp,))

    a0v, b0v = vec(a0), vec(b0)
    if np.min(a0v) < 1.0:
        raise ValueError("fused mixture requires every a0 >= 1 (elementwise gamma draw)")
    lgam = a0v * np.log(b0v) - np.array([math.lgamma(a) for a in a0v])
    lbv, ubv = (np.zeros(k_comp), np.zeros(k_comp)) if domain is None else (vec(domain[0]), vec(domain[1]))
    scal = np.concatenate([vec(mu0), vec(p0), a0v, b0v, vec(mu_init), vec(lam_init), lbv, ubv, lgam])
    n4 = n + (-n) % 4
    data = np.zeros((3 + k_comp, n4), np.float64)
    data[0, :n] = float(y.shape[1])
    data[1, :n] = y.sum(axis=1)
    data[2, :n] = (y * y).sum(axis=1)
    data[3:, :n] = np.log(prior).T
    f32 = dict(dtype=torch.float32, device=device)
    kw = dict(k_comp=k_comp, n=n, threads=block_threads(n), has_domain=domain is not None)
    return torch.as_tensor(scal, **f32).contiguous(), torch.as_tensor(data, **f32).contiguous(), kw


def run_fused_mixture(seed, y, prior, n_burn, n_iter, n_chains, mu0, p0, a0, b0, mu_init, lam_init, step=0.2,
                      domain=None, init=None, conjugate_means=False, store_z=False, n_thin=1, device="cuda",
                      bit_source=None):
    """The K-component Gaussian-mixture Gibbs run in one launch.

    Arguments as the JAX package's ``run_fused_mixture``: y (n,) or (n, r)
    replicate columns sharing each point's allocation; prior (n, K) constant
    allocation weights (rows need not be normalised); mu0/p0 the means' Normal
    prior (diagonal precision p0); a0/b0 the per-component Gamma
    hyperparameters, every a0 >= 1 (the elementwise Marsaglia-Tsang draw has no
    shape < 1 boost); mu_init/lam_init the initial values, the same for every
    chain; domain an optional (lb, ub) pair truncating the means' random-walk
    proposals; ``conjugate_means`` draws the means from their conjugate
    conditional instead (step and domain are then ignored and accept_total
    stays 0); ``store_z`` also returns each stored sweep's allocation.
    ``device`` is the card unless the caller asks for the CPU;
    ``bit_source(sweep, site, shape)`` replaces Philox (CPU only).

    Returns means/lams (chains, n_iter, K), log_post (chains, n_iter),
    accept_total (chains,): the means' accepted moves over burn-in and sampling,
    and with store_z z (chains, n_iter, n) int32."""
    if init is not None:
        raise NotImplementedError("run_fused_mixture(init=...) is not ported yet (ROADMAP.md queue 1: operations)")
    scal, data, kw = prepare(y, prior, mu0, p0, a0, b0, mu_init, lam_init, domain=domain, device=device)
    kw["has_domain"] = kw["has_domain"] and not conjugate_means
    return mixture_sweeps(
        seed, scal, data, int(n_chains), **kw, conjugate=bool(conjugate_means), step=float(step),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), store_z=bool(store_z), bit_source=bit_source,
    )
