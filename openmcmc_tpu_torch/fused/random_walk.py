"""Random-walk Metropolis on a p-vector location, the whole run in one launch (kernel K7).

Port of ``openmcmc_tpu/fused/random_walk.py`` (``run_fused_rw`` :190, kernel
``_make_kernel`` :46). Model, p <= 32 independent dimensions with a joint accept:

    y_ij ~ N(h_i, 1 / tau_i)  (j = 1..N),    h_i ~ N(mu_i, 1 / lam_i),

random-walk proposals h' = h + step * z, or truncated-normal proposals on a box
[lo, hi] with the asymmetric density correction. The data enter only through
S1_i = sum_j y_ij, S2_i = sum_j y_ij^2 and N, so a sweep is O(p) per chain: the
current log-density rides the carry and only the proposal's is evaluated,

    log pi(h) = const - sum_i [ tau_i/2 (S2_i - 2 h_i S1_i + N h_i^2) + lam_i/2 (h_i - mu_i)^2 ],

with const the normalising constants, so log_post equals ``Model.log_p``. With
``adapt`` each chain carries a log step-SCALE on the base step vector, nudged
toward the target acceptance by Robbins-Monro during burn-in only; the stored
log_step is that scale plus log(step[0]).

:func:`rw_sweeps` runs all sweeps for all chains: on CUDA tensors it launches
``csrc/random_walk.cu``, on CPU tensors it takes :func:`rw_sweeps_plain`, the
same sweep as a Python loop over sweeps vectorised over chains. The kernel
gives each chain W lanes, p rounded up to a power of two, one row a lane: the
rows' draws and terms run side by side and the sums gather them across the
lanes. Both evaluate every sum term by term in the JAX kernel's order: the
likelihood form cancels heavily (S2 is about 1.4e5 at the reference's example
2), so another order would move log_post by far more than rounding. ``const``
and log(step[0]) are computed once on the host and handed to both.

Bits as in :mod:`openmcmc_tpu_torch.fused.prng`: site 0 holds the p proposal
normals (truncated: the p truncated-draw uniforms, the JAX kernel's p single-row
sites in order), site 1 the accept uniform.

Not ported, because they exist for the TPU only: the BLOCK_B lane blocks, the
out_rows sublane padding and the double-buffered store DMAs. Resume (``init=``)
is not ported yet (ROADMAP.md queue 1: operations).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import store_index
from openmcmc_tpu_torch.utils import profiling

MAX_P = 32


def log_post_const(tau: np.ndarray, lam: np.ndarray, n_obs: float) -> float:
    """The log posterior's normalising constant in float32, summed over the
    dimensions in the JAX kernel's order:
    sum_i 1/2 (N log tau_i - N log 2 pi) + 1/2 (log lam_i - log 2 pi)."""
    f32 = np.float32
    n_log2pi = f32(n_obs * prng.LOG_2PI)
    const = f32(0.0)
    for t, lm in zip(np.asarray(tau, f32), np.asarray(lam, f32)):
        const = f32(const + f32(0.5) * (f32(n_obs) * np.log(t) - n_log2pi))
        const = f32(const + f32(0.5) * (np.log(lm) - f32(prng.LOG_2PI)))
    return float(const)


def _log_post(h, s1, s2, mu, tau, lam, n_obs, const):
    """log pi(h) for (chains, p) rows: the terms elementwise, then summed one
    dimension at a time in the kernel's order."""
    quad = s2 - 2.0 * h * s1 + n_obs * h * h
    r = h - mu
    lik, pri = 0.5 * tau * quad, 0.5 * lam * (r * r)
    total = const
    for i in range(h.shape[1]):
        total = total - lik[:, i] - pri[:, i]
    return total


@profiling.traced("kernel.random_walk")
def rw_sweeps_plain(seed, scal, n_chains, *, p, n_obs, const, log_step0, trunc, adapt, target, rate, n_burn,
                    n_keep, n_thin=1, bit_source=None):
    """Plain PyTorch version of the kernel: all sweeps for all chains.

    ``scal`` is the float32 vector [S1 | S2 | mu | tau | lam | h0 | step (| lo |
    hi)], p entries each (the JAX kernel's scalar block); ``n_obs`` is N,
    ``const`` :func:`log_post_const` and ``log_step0`` float32 log(step[0]).
    ``n_burn`` counts burn-in SWEEPS and ``n_keep`` stored draws, each after
    ``n_thin`` sweeps. Draws come from Philox (the kernel's bits) unless
    ``bit_source(sweep, site, shape)`` supplies them (CPU tensors only). Returns
    ``h`` (chains, n_keep, p), ``log_post``/``accept`` (chains, n_keep) and
    ``accept_total``/``log_step`` (chains,): the accept count over all sweeps
    and the final log step."""
    device = scal.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    f32 = dict(dtype=torch.float32, device=device)
    cols = scal.to(**f32).reshape(-1, p)
    s1, s2, mu, tau, lam, h0, stp = cols[:7]
    lo, hi = (cols[7], cols[8]) if trunc else (None, None)
    h = torch.zeros((n_chains, p), **f32) + h0
    lp = _log_post(h, s1, s2, mu, tau, lam, n_obs, const)
    acc = torch.zeros(n_chains, **f32)
    log_scale = torch.zeros(n_chains, **f32)
    out_h = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("log_post", "accept")}
    for it in range(n_burn + n_keep * n_thin):
        if bit_source is None:
            sites = prng.sweep_bits(seed, n_chains, it, [p, 1], device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate((p, 1))]
        step = stp * torch.exp(log_scale)[:, None] if adapt else stp
        if trunc:
            h_prop = prng.truncnorm_draw(h, step, lo, hi, (n_chains, p), lambda shape: sites[0])
            fwd = prng.truncnorm_logpdf(h, h_prop, step, lo, hi)
            rev = prng.truncnorm_logpdf(h_prop, h, step, lo, hi)
            corr = 0.0
            for i in range(p):
                corr = corr + fwd[:, i]
                corr = corr - rev[:, i]
        else:
            h_prop = h + step * prng.normal_icdf((n_chains, p), lambda shape: sites[0])
        lp_prop = _log_post(h_prop, s1, s2, mu, tau, lam, n_obs, const)
        log_accept = lp_prop - lp + corr if trunc else lp_prop - lp
        accept = torch.log(prng.uniform((n_chains, 1), lambda shape: sites[1])[:, 0]) < log_accept
        h = torch.where(accept[:, None], h_prop, h)
        lp = torch.where(accept, lp_prop, lp)
        acc = acc + accept.to(torch.float32)
        if adapt and it < n_burn:
            alpha = torch.exp(torch.clamp(log_accept, max=0.0))
            log_scale = log_scale + rate * (alpha - target)
        idx = store_index(it, n_burn, n_thin)
        if idx < 0:
            continue
        out_h[:, idx] = h
        out["log_post"][:, idx] = lp
        out["accept"][:, idx] = accept.to(torch.float32)
    return {"h": out_h, **out, "accept_total": acc, "log_step": log_scale + log_step0}


class RwParams(ctypes.Structure):
    """Mirror of ``struct RwParams`` in ``csrc/random_walk.cu``."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("trunc", ctypes.c_int32),
        ("adapt", ctypes.c_int32),
        ("n_obs", ctypes.c_float),
        ("cnst", ctypes.c_float),
        ("log_step0", ctypes.c_float),
        ("target", ctypes.c_float),
        ("rate", ctypes.c_float),
    ]


def _check_inputs(scal, n_chains, p, trunc):
    if p < 1 or p > MAX_P:
        raise ValueError(f"fused random walk supports 1 <= p <= {MAX_P}, got {p}")
    n = (9 if trunc else 7) * p
    if tuple(scal.shape) != (n,) or scal.dtype != torch.float32 or not scal.is_contiguous():
        raise ValueError(f"scal must be a contiguous float32 ({n},) tensor, got {tuple(scal.shape)} {scal.dtype}")
    if n_chains < 1:
        raise ValueError("need n_chains >= 1")


@profiling.traced("kernel.random_walk")
def rw_sweeps_kernel(seed, scal, n_chains, *, p, n_obs, const, log_step0, trunc, adapt, target, rate, n_burn,
                     n_keep, n_thin=1):
    """Launch ``csrc/random_walk.cu`` on a CUDA ``scal`` (arguments and results
    as :func:`rw_sweeps_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(scal, n_chains, p, trunc)
    if scal.device.type != "cuda":
        raise ValueError(f"random walk kernel: expected a CUDA tensor, got {scal.device}")
    if n_keep < 1 or n_burn < 0 or n_thin < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0 and n_thin >= 1")
    from openmcmc_tpu_torch import _build

    prm = RwParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=n_chains, p=p, n_sweeps=n_burn + n_keep * n_thin, n_burn=n_burn,
        n_thin=n_thin, n_keep=n_keep, trunc=int(bool(trunc)), adapt=int(bool(adapt)), n_obs=n_obs, cnst=const,
        log_step0=log_step0, target=target, rate=rate,
    )
    f32 = dict(dtype=torch.float32, device=scal.device)
    out_h = torch.empty((n_chains, n_keep, p), **f32)
    out = {k: torch.empty((n_chains, n_keep), **f32) for k in ("log_post", "accept")}
    last = {k: torch.empty((n_chains,), **f32) for k in ("accept_total", "log_step")}
    lib = _build.library()
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream(scal.device).cuda_stream
        err = lib.random_walk_launch(
            ctypes.byref(prm), scal.data_ptr(), out_h.data_ptr(), out["log_post"].data_ptr(),
            out["accept"].data_ptr(), last["accept_total"].data_ptr(), last["log_step"].data_ptr(), stream,
        )
    profiling.count("launch.random_walk")
    _build.check(err, "random_walk")
    return {"h": out_h, **out, **last}


def rw_sweeps(seed, scal, n_chains, *, bit_source=None, **kw):
    """All sweeps for all chains: the kernel for a CUDA ``scal``, the plain
    version for a CPU one. A CUDA call launches the kernel or raises."""
    if scal.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return rw_sweeps_kernel(seed, scal, n_chains, **kw)
    if scal.device.type != "cpu":
        raise ValueError(f"random walk: unsupported device {scal.device}")
    _check_inputs(scal, n_chains, kw["p"], kw["trunc"])
    return rw_sweeps_plain(seed, scal, n_chains, bit_source=bit_source, **kw)


def _host_vector(v, p) -> np.ndarray:
    """A number, array or tensor broadcast to a (p,) float32 host vector."""
    v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (p,)).copy()


def prepare(y, mu=0.0, tau=1.0, lam=1.0, step=0.2, h0=0.0, domain=None, device="cuda"):
    """The kernel's inputs for y (p, N) on ``device``: the float32 ``scal`` block
    [S1 | S2 | mu | tau | lam | h0 | step (| lo | hi)] and the keywords ``p``,
    ``n_obs``, ``const``, ``log_step0`` and ``trunc``."""
    y = y if torch.is_tensor(y) else torch.from_numpy(np.array(y, np.float32))
    y = y.to(device=device, dtype=torch.float32)
    p, n_obs = y.shape
    if p > MAX_P:
        raise ValueError(f"fused random walk supports p <= {MAX_P}, got {p}")
    tau_v, lam_v, step_v = _host_vector(tau, p), _host_vector(lam, p), _host_vector(step, p)
    host = [_host_vector(mu, p), tau_v, lam_v, _host_vector(h0, p), step_v]
    if domain is not None:
        host += [_host_vector(domain[0], p), _host_vector(domain[1], p)]
    scal = torch.cat([torch.sum(y, dim=1), torch.sum(y * y, dim=1)] + [torch.from_numpy(v).to(y.device) for v in host])
    kw = dict(p=p, n_obs=float(n_obs), const=log_post_const(tau_v, lam_v, float(n_obs)),
              log_step0=float(np.log(step_v[0])), trunc=domain is not None)
    return scal.contiguous(), kw


def run_fused_rw(
    seed, y, n_burn, n_iter, n_chains, mu=0.0, tau=1.0, lam=1.0, step=0.2, h0=0.0,
    adapt_step=False, target_accept=0.234, adapt_rate=0.05, domain=None, n_thin=1, device="cuda",
    bit_source=None,
):
    """Random-walk MH for h | y, the whole run in one launch.

    Arguments as the JAX package's ``run_fused_rw``: y is (N,) for a scalar h or
    (p, N) for a p-dimensional h (p <= 32); mu/tau/lam/h0/step broadcast to (p,);
    ``domain`` is an optional (lower, upper) pair of proposal bounds;
    ``n_burn`` the burn-in SWEEP count, ``n_iter`` the stored draws, each after
    ``n_thin`` sweeps. ``device`` is the card unless the caller asks for the
    CPU; ``bit_source(sweep, site, shape)`` replaces Philox (CPU only). Returns h
    (chains, n_iter) for a scalar h or (chains, n_iter, p), log_post and accept
    (chains, n_iter), and accept_total and log_step (chains,): the accept count
    over burn-in and sampling, and the final log step."""
    y = y if torch.is_tensor(y) else torch.from_numpy(np.array(y, np.float32))
    scalar_out = y.dim() == 1
    scal, kw = prepare(y[None, :] if scalar_out else y, mu=mu, tau=tau, lam=lam, step=step, h0=h0, domain=domain,
                       device=device)
    out = rw_sweeps(
        seed, scal, int(n_chains), **kw, adapt=bool(adapt_step), target=float(target_accept), rate=float(adapt_rate),
        n_burn=int(n_burn), n_keep=int(n_iter), n_thin=int(n_thin), bit_source=bit_source,
    )
    if scalar_out:
        out["h"] = out["h"][..., 0]
    return out
