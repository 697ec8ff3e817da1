"""The reversible-jump knot-basis regression in one launch (kernel K11).

Port of ``openmcmc_tpu/fused/rj.py`` (``run_fused_rj`` :703, kernel
``_make_kernel`` :86). Model, padded to n_max <= 32:

    k        ~ Poisson(rho)            (active knots, 1..n_max)
    theta_j  ~ U(lo, hi)               (knot locations, j < k)
    omega_j  ~ Gamma(a_om, b_om)       (kernel widths, j < k)
    beta     ~ N(mu_b, tau_b^-1 I_k)   (coefficients)
    y        ~ Null, or N(B beta, (tau I)^-1) with tau ~ Gamma(a_tau, b_tau)
               (B[:, j] = normpdf(X; theta_j, omega_j))

One sweep, as the JAX kernel runs it: masked manifold MALA on beta (Null: the
constant diagonal metric; likelihood: the Fisher metric tau B'B + tau_b I through
a column Cholesky); truncated random walks on theta (uniform target) and omega
(Gamma target), per column at once (Null) or column by column with the running
residual (likelihood); a birth or death with prediction-matched coefficient
transitions, where S_birth, C_birth, S_death and C_death are rank-one diagonal
modifications of one Gram of the masked basis and every factorization is a
Cholesky with pivots clamped at 1e-30; with a likelihood, the conjugate Gamma
draw of tau and the end-of-sweep log posterior.

:func:`rj_sweeps` runs all sweeps for all chains: on CUDA tensors it launches
``csrc/rj.cu``, on CPU tensors it takes :func:`rj_sweeps_plain`, the same sweep
as a Python loop over sweeps vectorised over chains (the padded index j is the
last axis, the kernel's lane). Both take per-chain initial rows (beta, theta,
omega, k, tau, the six counters); a broadcast start is the special case.

Summation order, the same in kernel and plain version (the sums feed accept
decisions and log-determinant differences):

- a sum over the n_data rows (:func:`dsum`): lane l of a warp adds rows l, l + 32,
  l + 64, ... in ascending order, then the 32 partials meet in a halving tree,
  ``x = x[:h] + x[h:2h]`` for h = 16, 8, 4, 2, 1;
- a sum over the padded index j (the p rows of a column), a matrix-vector
  product and the Cholesky's updates: one term at a time in ascending order, as
  the JAX kernel writes them; the triangular solves in the JAX kernel's order.

The JAX kernel sums by XLA's reductions; the two agree to float32 rounding.

Bits as in :mod:`openmcmc_tpu_torch.fused.prng`, counter (chain, sweep, site,
j / 4), every draw of the sweep a site of its own in the JAX kernel's order
(:func:`site_map`): the mMALA normals (p) and accept uniform; the theta draws
and accept uniforms, then omega's (Null: one site of p each; likelihood: p
single-row sites each, the column loop's order); the move uniform, the new
knot's uniform, the new width's Gamma rounds, the matched coefficient's draw,
the deletion uniform, the accept uniform; with a likelihood, tau's Gamma rounds.

Not ported, because they exist for the TPU only: the BLOCK_B lane blocks, the
double-buffered store DMA and the concrete-layout zero trick. ``init=`` takes
per-chain initial rows, the warm start ``MCMC.run(resume=...)`` gives it.
"""

from __future__ import annotations

import ctypes
from math import lgamma

import numpy as np
import torch

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.fused.layout import store_index, to_host, upload
from openmcmc_tpu_torch.utils import profiling

MAX_N_MAX = 32
OUT_ROWS = 8  # k, log_post, acc_mmala, acc_theta, acc_omega, acc_rj, prop_theta, prop_omega
RIDGE = 1e-6
LANES = 32  # the warp: the data sums' partials
_SQRT_2PI = 2.5066282746310002
_F32 = np.float32


def _f(x) -> float:
    """A host constant rounded to float32, as JAX rounds a Python float operand."""
    return float(_F32(x))


# ---------------------------------------------------------------------------
# host side: the sweep's site map and the kernel's parameters
# ---------------------------------------------------------------------------


def _gamma_sites(a: float) -> int:
    """Draw sites of one ``gamma_mt`` draw of static shape ``a``."""
    boost = a < 1.0
    return 2 * prng._mt_rounds(a + 1.0 if boost else a) + int(boost)


def site_map(p: int, lik: bool, a_om: float, a_tau_star: float):
    """The sweep's draw sites, in the JAX kernel's order: a dict of the first
    site of each draw, and the element count of every site."""
    widths = [p, 1]  # the mMALA normals, its accept uniform
    if lik:
        widths += [1] * (4 * p)  # theta draw and accept per column, then omega's
    else:
        widths += [p] * 4  # theta draws, accepts, omega draws, accepts
    sites = {"move": len(widths), "th_new": len(widths) + 1, "g_om": len(widths) + 2}
    widths += [1, 1] + [1] * _gamma_sites(a_om)
    sites.update(draw=len(widths), delete=len(widths) + 1, accept=len(widths) + 2)
    widths += [1, 1, 1]
    if lik:
        sites["g_tau"] = len(widths)
        widths += [1] * _gamma_sites(a_tau_star)
    return sites, widths


class RjParams(ctypes.Structure):
    """Mirror of ``struct RjParams`` in ``csrc/rj.cu``: the run's sizes and
    sites, and every constant of the sweep rounded to float32 on the host as the
    JAX kernel rounds its Python-float operands."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("n_chains", ctypes.c_int32),
        ("p", ctypes.c_int32),
        ("n_data", ctypes.c_int32),
        ("n_sweeps", ctypes.c_int32),
        ("n_burn", ctypes.c_int32),
        ("n_thin", ctypes.c_int32),
        ("n_keep", ctypes.c_int32),
        ("lik", ctypes.c_int32),
        ("stream", ctypes.c_int32),
        ("n_rows", ctypes.c_int32),
        ("n_init", ctypes.c_int32),
        ("site_move", ctypes.c_int32),
        ("site_th_new", ctypes.c_int32),
        ("site_draw", ctypes.c_int32),
        ("site_delete", ctypes.c_int32),
        ("site_accept", ctypes.c_int32),
        ("g_om", prng.GammaSpec),
        ("g_tau", prng.GammaSpec),
        ("rho", ctypes.c_float),
        ("log_rho", ctypes.c_float),
        ("mu_b", ctypes.c_float),
        ("tau_b", ctypes.c_float),
        ("half_tau_b", ctypes.c_float),  # 0.5 tau_b
        ("neg_half_tau_b", ctypes.c_float),  # -0.5 tau_b
        ("log_tau_term", ctypes.c_float),  # 0.5 (log tau_b - log 2 pi)
        ("a_om_m1", ctypes.c_float),  # a_om - 1
        ("b_om", ctypes.c_float),
        ("lgam_om", ctypes.c_float),  # a_om log b_om - lgamma(a_om)
        ("log_range_th", ctypes.c_float),
        ("th_lo", ctypes.c_float),
        ("th_hi", ctypes.c_float),
        ("th_range", ctypes.c_float),
        ("om_lo", ctypes.c_float),
        ("om_hi", ctypes.c_float),
        ("m_lo", ctypes.c_float),
        ("m_hi", ctypes.c_float),
        ("m_scale", ctypes.c_float),
        ("s_theta", ctypes.c_float),
        ("s_omega", ctypes.c_float),
        ("s_mmala", ctypes.c_float),
        ("drift", ctypes.c_float),  # Null mMALA: 1 - s^2 / 2
        ("drift_c", ctypes.c_float),  # (1 - drift) mu_b
        ("sigma", ctypes.c_float),  # s / sqrt(tau_b)
        ("c_prop", ctypes.c_float),  # 0.5 tau_b / s^2
        ("half_s2", ctypes.c_float),  # likelihood mMALA: 0.5 s^2
        ("c_q", ctypes.c_float),  # -0.5 / s^2
        ("half_n", ctypes.c_float),
        ("a_tau_m1", ctypes.c_float),
        ("b_tau", ctypes.c_float),
        ("lgam_tau", ctypes.c_float),
        ("log_ints", ctypes.c_float * MAX_N_MAX),  # log(i) for i = 1..32
    ]


class RjConfig:
    """The kernel's :class:`RjParams` and the two Gamma shapes in float64 (the
    plain version's ``gamma_mt`` takes them as the JAX kernel does)."""

    def __init__(self, prm: RjParams, widths, a_om: float, a_tau_star: float):
        self.prm = prm
        self.widths = list(widths)
        self.a_om = a_om
        self.a_tau_star = a_tau_star


def make_config(n_max, n_data, *, rho=8.0, mu_beta=0.0, tau_beta=0.25, a_omega=3.0, b_omega=2.0,
                theta_limits=(-10.0, 10.0), omega_rw_limits=(0.5, 2.0), match_limits=(-10.0, 10.0), match_scale=1.0,
                step_mmala=0.5, step_theta=0.1, step_omega=0.1, likelihood=False, a_tau=2.0, b_tau=1.0,
                stream=False, n_burn=0, n_keep=1, n_thin=1, seed=0, n_chains=1) -> RjConfig:
    """Every constant of the sweep, computed in float64 on the host in the JAX
    kernel's grouping (``rj.py:90-120``) and rounded to float32."""
    p, lik = int(n_max), bool(likelihood)
    if not 1 <= p <= MAX_N_MAX:
        raise ValueError(f"fused reversible jump supports 1 <= n_max <= {MAX_N_MAX}, got {p}")
    if n_data < 1:
        raise ValueError("need n_data >= 1")
    if n_keep < 1 or n_burn < 0 or n_thin < 1 or n_chains < 1:
        raise ValueError("need n_keep >= 1, n_burn >= 0, n_thin >= 1 and n_chains >= 1")
    rho, mu_b, tau_b = float(rho), float(mu_beta), float(tau_beta)
    a_om, b_om = float(a_omega), float(b_omega)
    s = float(step_mmala)
    half_n = 0.5 * float(n_data)
    a_tau_star = float(a_tau) + half_n
    sites, widths = site_map(p, lik, a_om, a_tau_star)
    g_om = prng._single_spec(a_om, sites["g_om"])
    g_tau = prng._single_spec(a_tau_star, sites["g_tau"]) if lik else prng.GammaSpec()
    drift = 1.0 - 0.5 * s * s
    n_rows = OUT_ROWS + int(lik) + (3 * p if stream else 0)
    prm = RjParams(
        seed=int(seed) & 0xFFFFFFFF, n_chains=int(n_chains), p=p, n_data=int(n_data),
        n_sweeps=int(n_burn) + int(n_keep) * int(n_thin), n_burn=int(n_burn), n_thin=int(n_thin), n_keep=int(n_keep),
        lik=int(lik), stream=int(bool(stream)), n_rows=n_rows, n_init=3 * p + 7 + int(lik),
        site_move=sites["move"], site_th_new=sites["th_new"], site_draw=sites["draw"], site_delete=sites["delete"],
        site_accept=sites["accept"], g_om=g_om, g_tau=g_tau,
        rho=_f(rho), log_rho=_f(np.log(rho)), mu_b=_f(mu_b), tau_b=_f(tau_b), half_tau_b=_f(0.5 * tau_b),
        neg_half_tau_b=_f(-0.5 * tau_b), log_tau_term=_f(0.5 * (np.log(tau_b) - prng.LOG_2PI)), a_om_m1=_f(a_om - 1.0),
        b_om=_f(b_om), lgam_om=_f(a_om * np.log(b_om) - lgamma(a_om)),
        log_range_th=_f(np.log(theta_limits[1] - theta_limits[0])), th_lo=_f(theta_limits[0]),
        th_hi=_f(theta_limits[1]), th_range=_f(theta_limits[1] - theta_limits[0]), om_lo=_f(omega_rw_limits[0]),
        om_hi=_f(omega_rw_limits[1]), m_lo=_f(match_limits[0]), m_hi=_f(match_limits[1]), m_scale=_f(match_scale),
        s_theta=_f(step_theta), s_omega=_f(step_omega), s_mmala=_f(s), drift=_f(drift), drift_c=_f((1.0 - drift) * mu_b),
        sigma=_f(s / float(np.sqrt(tau_b))), c_prop=_f(0.5 * tau_b / (s * s)), half_s2=_f(0.5 * (s * s)),
        c_q=_f(-0.5 / (s * s)), half_n=_f(half_n), a_tau_m1=_f(float(a_tau) - 1.0), b_tau=_f(b_tau),
        lgam_tau=_f(float(a_tau) * np.log(float(b_tau)) - lgamma(float(a_tau))) if lik else 0.0,
    )
    for i in range(MAX_N_MAX):
        prm.log_ints[i] = _f(np.log(i + 1))
    return RjConfig(prm, widths, a_om, a_tau_star)


def init_rows(n_chains, n_max, beta0, theta0, omega0, k0, tau0=None, counters=None, device="cuda"):
    """The per-chain initial rows (chains, 3 n_max + 7 [+ 1]) float32:
    [beta | theta | omega | k | (tau) | acc_mmala, acc_theta, acc_omega, acc_rj,
    prop_theta, prop_omega], each value broadcast over chains when it has none
    of its own (the JAX kernel's warm layout, ``rj.py:614-628``, per chain)."""
    p = int(n_max)

    def rows(v, width):
        t = torch.as_tensor(np.asarray(to_host(v) if torch.is_tensor(v) else v, np.float32))
        return t.reshape(-1, width).expand(n_chains, width) if t.numel() == width else t.reshape(n_chains, width)

    parts = [rows(beta0, p), rows(theta0, p), rows(omega0, p), rows(k0, 1)]
    if tau0 is not None:
        parts.append(rows(tau0, 1))
    parts.append(rows(np.zeros(6, np.float32) if counters is None else counters, 6))
    return upload(torch.cat(parts, dim=1), device)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def dsum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (the data rows) in the kernel's order: lane l adds
    rows l, l + 32, ... ascending, then the 32 partials meet in a halving tree."""
    n = v.shape[-1]
    rows = max(1, -(-n // LANES))
    pad = v.new_zeros(v.shape[:-1] + (rows * LANES,))
    pad[..., :n] = v
    w = pad.reshape(v.shape[:-1] + (rows, LANES))
    s = w[..., 0, :]
    for r in range(1, rows):
        s = s + w[..., r, :]
    h = LANES // 2
    while h:
        s = s[..., :h] + s[..., h:2 * h]
        h //= 2
    return s[..., 0]


def jsum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (the padded index j) one term at a time, ascending."""
    s = v[..., 0]
    for j in range(1, v.shape[-1]):
        s = s + v[..., j]
    return s


def _basis(X, th, om, active):
    """Basis columns (..., p, n_data): exp(-z^2/2) / (om sqrt(2 pi)) * active,
    z = (X - th) / om, the JAX kernel's ``basis_col`` with om <= 0 read as 1."""
    om_safe = torch.where(om > 0.0, om, 1.0)[..., None]
    z = (X - th[..., None]) / om_safe
    return torch.exp(-0.5 * z * z) / (om_safe * _SQRT_2PI) * active[..., None]


def _chol(S: torch.Tensor):
    """Left-looking Cholesky of (C, p, p) (the JAX kernel's ``chol_cols``):
    column j minus L[:, m] L[j, m] for m < j in order, pivot sqrt(max(., 1e-30)),
    2 log d added to log det in column order. Returns (L, logdet)."""
    C, p, _ = S.shape
    L = torch.zeros_like(S)
    logdet = torch.zeros(C, dtype=S.dtype, device=S.device)
    rows = torch.arange(p, device=S.device)
    for j in range(p):
        col = S[:, :, j]
        for m in range(j):
            col = col - L[:, :, m] * L[:, j, m:m + 1]
        d = torch.sqrt(torch.clamp(col[:, j], min=1e-30))
        logdet = logdet + 2.0 * torch.log(d)
        L[:, :, j] = torch.where(rows >= j, col / d[:, None], 0.0)
    return L, logdet


def _back(L: torch.Tensor, z):
    """L' x = z, z a list of p (C,) rows (``chol_backsolve``): x_i = (z_i -
    sum_{m > i} L[m, i] x_m) / L[i, i], the sum in ascending m."""
    p = L.shape[-1]
    x = [None] * p
    for i in range(p - 1, -1, -1):
        acc = z[i]
        for m in range(i + 1, p):
            acc = acc - L[:, m, i] * x[m]
        x[i] = acc / L[:, i, i]
    return torch.stack(x, dim=1)


def _solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """A x = r from the column Cholesky of A (``chol_solve_1rhs``): the forward
    pass updates the whole residual column by column, then :func:`_back`."""
    w, res = [], r
    for i in range(L.shape[-1]):
        wi = res[:, i] / L[:, i, i]
        w.append(wi)
        res = res - L[:, :, i] * wi[:, None]
    return _back(L, w)


def _model_log_p(c: RjParams, kf, beta, theta, omega, m, log_ints):
    """The joint log density without the likelihood (``model_log_p``)."""
    log_fact = torch.zeros_like(kf)
    for i in range(2, c.p + 1):
        log_fact = log_fact + torch.where(float(i) <= kf, log_ints[i - 1], 0.0)
    lp = kf * c.log_rho - c.rho - log_fact - kf * c.log_range_th
    r = beta - c.mu_b
    om_safe = torch.where(m > 0.0, omega, 1.0)
    terms = c.log_tau_term - c.half_tau_b * r * r + c.a_om_m1 * torch.log(om_safe) - c.b_om * om_safe + c.lgam_om
    return lp + jsum(m * terms)


def _gram(bas):
    """The masked basis's Gram (C, p, p), each entry one :func:`dsum`."""
    return dsum(bas[:, :, None, :] * bas[:, None, :, :])


@profiling.traced("kernel.rj")
def rj_sweeps_plain(data, init, n_chains, *, config: RjConfig, bit_source=None):
    """Plain PyTorch version of the kernel: every sweep for every chain.

    ``data`` is the float32 (n_data,) X, or (2, n_data) [X | y] with a
    likelihood; ``init`` the (chains, n_init) initial rows (:func:`init_rows`);
    ``config`` the sizes, constants and seed (:func:`make_config`). Draws come
    from Philox (the kernel's bits) unless ``bit_source(sweep, site, shape)`` supplies
    them (CPU tensors only). Returns ``out`` (chains, n_keep, n_rows) float32:
    per stored sweep [k, log_post, the six counters, (tau), (beta | theta |
    omega when streamed)], the counters accumulated from the initial rows."""
    c = config.prm
    device = init.device
    if bit_source is not None and device.type != "cpu":
        raise ValueError("an injected bit source replaces Philox on the CPU only")
    p, nd, lik = c.p, c.n_data, bool(c.lik)
    f32 = dict(dtype=torch.float32, device=device)
    data = data.to(**f32).reshape(-1, nd)
    X = data[0]
    Y = data[1] if lik else None
    log_ints = torch.tensor(list(c.log_ints), **f32)
    init = init.to(**f32)
    beta, theta, omega = init[:, :p].clone(), init[:, p:2 * p].clone(), init[:, 2 * p:3 * p].clone()
    kf = init[:, 3 * p].clone()
    base = 3 * p + 1
    tau = None
    if lik:
        tau = init[:, base].clone()
        base += 1
    acc_m, acc_t, acc_o, acc_r, prop_t, prop_o = (init[:, base + i].clone() for i in range(6))
    out = torch.zeros((n_chains, c.n_keep, c.n_rows), **f32)
    idx_p = torch.arange(p, device=device)
    ridx = idx_p.to(torch.float32)
    s_th, th_lo, th_hi = (torch.tensor(v, **f32) for v in (c.s_theta, c.th_lo, c.th_hi))
    s_om, om_lo, om_hi = (torch.tensor(v, **f32) for v in (c.s_omega, c.om_lo, c.om_hi))
    m_sc, m_lo, m_hi = (torch.tensor(v, **f32) for v in (c.m_scale, c.m_lo, c.m_hi))
    eye = torch.eye(p, dtype=torch.bool, device=device)

    for it in range(c.n_sweeps):
        if bit_source is None:
            sites = prng.sweep_bits(c.seed, n_chains, it, config.widths, device)
        else:
            sites = [bit_source(it, k, (n_chains, w)) for k, w in enumerate(config.widths)]

        def site(k):
            return lambda shape: sites[k]

        def uni(k):
            return prng.uniform((n_chains, 1), site(k))[:, 0]

        m = (ridx < kf[:, None]).to(torch.float32)  # (C, p)
        if lik:
            bas = _basis(X, theta, omega, m)  # (C, p, n_data)
            fit = torch.zeros((n_chains, nd), **f32)
            for j in range(p):
                fit = fit + bas[:, j] * beta[:, j:j + 1]
            r = Y - fit

        # ==== 1. manifold MALA on beta ========================================
        if lik:
            G = _gram(bas)
            g = (tau[:, None] * dsum(bas * r[:, None, :]) - c.tau_b * (beta - c.mu_b)) * m
            H = (tau[:, None, None] * G) * m[:, :, None] * m[:, None, :]
            H = H + torch.where(eye, (c.tau_b * m + (1.0 - m))[:, None, :], 0.0)
            L_h, _ = _chol(H)
            hg = _solve(L_h, g)
            z = prng.normal_icdf((n_chains, p), site(0)) * m
            ltz = _back(L_h, list(z.unbind(1)))
            mu_f = beta + c.half_s2 * hg
            beta_prop = torch.where(m > 0.0, mu_f + c.s_mmala * ltz, beta)
            delta = beta_prop - beta
            d_r = beta - (beta_prop + c.half_s2 * (hg - delta))
            Hdr = torch.zeros_like(beta)
            for j in range(p):
                Hdr = Hdr + H[:, :, j] * d_r[:, j:j + 1]
            q_r = jsum(d_r * Hdr)
            zz = jsum(z * z)
            logq_diff = c.c_q * q_r + 0.5 * zz
            dB = torch.zeros((n_chains, nd), **f32)
            for j in range(p):
                dB = dB + bas[:, j] * delta[:, j:j + 1]
            d_ll = tau * dsum(r * dB) - 0.5 * tau * dsum(dB * dB)
            d_prior = jsum(m * (c.neg_half_tau_b * ((beta_prop - c.mu_b) ** 2 - (beta - c.mu_b) ** 2)))
            acc = torch.log(uni(1)) < (d_prior + d_ll + logq_diff)
            beta = torch.where(acc[:, None], beta_prop, beta)
            r = torch.where(acc[:, None], r - dB, r)
        else:
            z = prng.normal_icdf((n_chains, p), site(0))
            mu_f = c.drift * beta + c.drift_c
            beta_prop = torch.where(m > 0.0, mu_f + c.sigma * z, beta)
            mu_r = c.drift * beta_prop + c.drift_c
            dlp = jsum(m * (c.neg_half_tau_b * ((beta_prop - c.mu_b) ** 2 - (beta - c.mu_b) ** 2)
                            - c.c_prop * ((beta - mu_r) ** 2 - (beta_prop - mu_f) ** 2)))
            acc = torch.log(uni(1)) < dlp
            beta = torch.where(acc[:, None], beta_prop, beta)
        acc_m = acc_m + acc.to(torch.float32)

        # ==== 2/3. truncated random walks on theta and omega =================
        if lik:
            # column by column with the running residual. A column's proposal,
            # new basis column and density terms read only its own entries, which
            # no earlier column of the pass changes, so they are made for all
            # columns at once; the residual's sum and the accept run in column order
            for pass_ in range(2):
                s0 = 2 + 2 * p * pass_
                bits = torch.cat([sites[s0 + 2 * j] for j in range(p)], dim=1)
                log_u = torch.log(prng.uniform((n_chains, p), lambda shape: torch.cat(
                    [sites[s0 + 2 * j + 1] for j in range(p)], dim=1)))
                if pass_ == 0:
                    new = prng.truncnorm_draw(theta, s_th, th_lo, th_hi, (n_chains, p), lambda shape: bits)
                    c_new = _basis(X, new, omega, m)
                    ratio = (prng.truncnorm_logpdf(theta, new, s_th, th_lo, th_hi)
                             - prng.truncnorm_logpdf(new, theta, s_th, th_lo, th_hi))
                else:
                    new = prng.truncnorm_draw(omega, s_om, om_lo, om_hi, (n_chains, p), lambda shape: bits)
                    c_new = _basis(X, theta, new, m)
                    om_safe_c = torch.where(omega > 0.0, omega, 1.0)
                    om_safe_p = torch.where(new > 0.0, new, 1.0)
                    dtarget = c.a_om_m1 * (torch.log(om_safe_p) - torch.log(om_safe_c)) - c.b_om * (new - omega)
                    ratio = (prng.truncnorm_logpdf(omega, new, s_om, om_lo, om_hi)
                             - prng.truncnorm_logpdf(new, omega, s_om, om_lo, om_hi))
                dc = (c_new - bas) * beta[:, :, None]  # (C, p, n_data)
                dc_sq = dsum(dc * dc)
                accepted = torch.zeros((n_chains, p), dtype=torch.bool, device=device)
                for j in range(p):
                    d_ll = tau * dsum(r * dc[:, j]) - 0.5 * tau * dc_sq[:, j]
                    if pass_ == 0:
                        acc_j = (log_u[:, j] < (d_ll + ratio[:, j])) & (m[:, j] > 0.0)
                    else:
                        acc_j = (log_u[:, j] < (dtarget[:, j] + d_ll + ratio[:, j])) & (m[:, j] > 0.0)
                        acc_j = acc_j & (new[:, j] > 0.0)  # an exact-0 width would zero a live column
                    r = torch.where(acc_j[:, None], r - dc[:, j], r)
                    accepted[:, j] = acc_j
                n_acc = jsum(accepted.to(torch.float32))
                bas = torch.where(accepted[:, :, None], c_new, bas)
                if pass_ == 0:
                    theta = torch.where(accepted, new, theta)
                    acc_t = acc_t + n_acc
                    prop_t = prop_t + kf
                else:
                    omega = torch.where(accepted, new, omega)
                    acc_o = acc_o + n_acc
                    prop_o = prop_o + kf
        else:
            th_prop = prng.truncnorm_draw(theta, s_th, th_lo, th_hi, (n_chains, p), site(2))
            lf = prng.truncnorm_logpdf(th_prop, theta, s_th, th_lo, th_hi)
            lr = prng.truncnorm_logpdf(theta, th_prop, s_th, th_lo, th_hi)
            acc_cols = (torch.log(prng.uniform((n_chains, p), site(3))) < (lr - lf)) & (m > 0.0)
            theta = torch.where(acc_cols, th_prop, theta)
            acc_t = acc_t + jsum(acc_cols.to(torch.float32))
            prop_t = prop_t + kf
            om_prop = prng.truncnorm_draw(omega, s_om, om_lo, om_hi, (n_chains, p), site(4))
            lf = prng.truncnorm_logpdf(om_prop, omega, s_om, om_lo, om_hi)
            lr = prng.truncnorm_logpdf(omega, om_prop, s_om, om_lo, om_hi)
            om_safe_c = torch.where(omega > 0.0, omega, 1.0)
            om_safe_p = torch.where(om_prop > 0.0, om_prop, 1.0)
            dtarget = c.a_om_m1 * (torch.log(om_safe_p) - torch.log(om_safe_c)) - c.b_om * (om_prop - omega)
            acc_cols = (torch.log(prng.uniform((n_chains, p), site(5))) < (dtarget + lr - lf)) & (m > 0.0)
            acc_cols = acc_cols & (om_prop > 0.0)
            omega = torch.where(acc_cols, om_prop, omega)
            acc_o = acc_o + jsum(acc_cols.to(torch.float32))
            prop_o = prop_o + kf
            bas = _basis(X, theta, omega, m)

        # ==== 4. reversible jump =============================================
        G0 = _gram(bas)
        u_move = uni(c.site_move)
        birth = torch.where(kf >= float(p), False, torch.where(kf <= 1.0, True, u_move <= 0.5))

        # ---- birth
        th_new = c.th_lo + c.th_range * uni(c.site_th_new)
        ones = torch.ones((n_chains, 1), **f32)
        om_new = prng.gamma_mt(config.a_om, torch.full((n_chains, 1), c.b_om, **f32),
                               prng.SiteStream(sites[c.g_om.site0:]))[:, 0]
        new_col = _basis(X, th_new[:, None], om_new[:, None], ones)[:, 0]  # (C, n_data)
        log_new = -c.log_range_th + c.a_om_m1 * torch.log(om_new) - c.b_om * om_new + c.lgam_om
        ndot = dsum(new_col[:, None, :] * bas)  # (C, p): new . bas[j]
        nn = dsum(new_col * new_col)
        kcol = kf[:, None]
        is_k = ridx == kcol  # (C, p) row or column k
        lt_k, lt_k1 = ridx < kcol, ridx < kcol + 1.0
        S_b = torch.where(is_k[:, :, None], ndot[:, None, :], G0)  # row k -> new . bas[j]
        nd_kk = torch.where(is_k, nn[:, None], ndot)
        S_b = torch.where(is_k[:, None, :], nd_kk[:, :, None], S_b)  # column k -> the new dots
        S_b = torch.where(lt_k1[:, :, None] & lt_k1[:, None, :], S_b, 0.0)
        S_b = S_b + torch.where(eye, torch.where(lt_k1, RIDGE, 1.0)[:, None, :], 0.0)
        L_b, logdet_Sb = _chol(S_b)
        r_data = torch.zeros((n_chains, nd), **f32)
        for j in range(p):
            r_data = r_data + bas[:, j] * beta[:, j:j + 1]
        base_dot = dsum(bas * r_data[:, None, :])
        new_dot_r = dsum(new_col * r_data)
        rhs = torch.where(lt_k1, torch.where(is_k, new_dot_r[:, None], base_dot), 0.0)
        mu_star = _solve(L_b, rhs)
        mu_new = torch.sum(torch.where(is_k, mu_star, 0.0), dim=1)
        draw = prng.truncnorm_draw(mu_new[:, None], m_sc, m_lo, m_hi, (n_chains, 1), site(c.site_draw))[:, 0]
        log_draw = prng.truncnorm_logpdf(draw, mu_new, m_sc, m_lo, m_hi)
        beta_birth = torch.where(lt_k, mu_star, torch.where(is_k, draw[:, None], 0.0))
        C_b = S_b - torch.where(eye, torch.where(lt_k, RIDGE, 0.0)[:, None, :], 0.0)
        _, logdet_Cb = _chol(C_b)
        ld_F_birth = logdet_Cb - logdet_Sb
        pb_fwd = torch.where(kf <= 1.0, 1.0, 0.5)
        pd_rev = torch.where(kf >= float(p - 1), 1.0, 0.5)
        birth_fwd = torch.log(pb_fwd) + log_new + log_draw
        birth_rev = torch.log(pd_rev) + ld_F_birth
        th_birth = torch.where(is_k, th_new[:, None], theta)
        om_birth = torch.where(is_k, om_new[:, None], omega)

        # ---- death
        u_del = uni(c.site_delete)
        jf = torch.clamp(torch.floor(u_del * kf), min=0.0)
        jf = torch.minimum(jf, torch.clamp(kf - 1.0, min=0.0))
        is_j = ridx == jf[:, None]
        om_del = torch.sum(torch.where(is_j, omega, 0.0), dim=1)
        om_del_safe = torch.where(om_del > 0.0, om_del, 1.0)
        log_del = -c.log_range_th + c.a_om_m1 * torch.log(om_del_safe) - c.b_om * om_del_safe + c.lgam_om
        S_d = torch.where(lt_k[:, :, None] & lt_k[:, None, :], G0, 0.0)
        S_d = S_d + torch.where(eye, torch.where(lt_k, RIDGE, 1.0)[:, None, :], 0.0)
        _, logdet_Sd = _chol(S_d)
        dd = RIDGE * (is_j.to(torch.float32) - lt_k.to(torch.float32))
        C_d = S_d + torch.where(eye, dd[:, None, :], 0.0)
        L_cd, logdet_Cd = _chol(C_d)
        S_beta = torch.zeros_like(beta)
        for j in range(p):
            S_beta = S_beta + S_d[:, :, j] * beta[:, j:j + 1]
        mu_aug = _solve(L_cd, S_beta)
        ld_F_death = logdet_Cd - logdet_Sd
        param_del = torch.sum(torch.where(is_j, mu_aug, 0.0), dim=1)
        log_rev_draw = prng.truncnorm_logpdf(param_del, torch.zeros_like(param_del), m_sc, m_lo, m_hi)

        def shift_delete(v):
            nxt = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
            out_v = torch.where(ridx < jf[:, None], v, nxt)
            return torch.where(ridx < (kf - 1.0)[:, None], out_v, 0.0)

        beta_death, th_death, om_death = shift_delete(mu_aug), shift_delete(theta), shift_delete(omega)
        pd_fwd = torch.where(kf >= float(p), 1.0, 0.5)
        pb_rev = torch.where(kf <= 2.0, 1.0, 0.5)
        death_fwd = torch.log(pd_fwd) + ld_F_death
        death_rev = torch.log(pb_rev) + log_del + log_rev_draw

        # ---- branch select and accept
        kf_prop = torch.where(birth, kf + 1.0, kf - 1.0)
        bsel = birth[:, None]
        beta_p = torch.where(bsel, beta_birth, beta_death)
        th_p = torch.where(bsel, th_birth, th_death)
        om_p = torch.where(bsel, om_birth, om_death)
        logp_fwd = torch.where(birth, birth_fwd, death_fwd)
        logp_rev = torch.where(birth, birth_rev, death_rev)
        m_prop = (ridx < kf_prop[:, None]).to(torch.float32)
        lp_cur = _model_log_p(c, kf, beta, theta, omega, m, log_ints)
        lp_prop = _model_log_p(c, kf_prop, beta_p, th_p, om_p, m_prop, log_ints)
        if lik:
            quad_cur = dsum(r * r)
            fit_b = torch.zeros((n_chains, nd), **f32)
            coef_b = torch.where(lt_k, mu_star, 0.0)
            coef_d = torch.where(lt_k & ~is_j, mu_aug, 0.0)
            fit_d = torch.zeros((n_chains, nd), **f32)
            for i in range(p):
                fit_b = fit_b + bas[:, i] * coef_b[:, i:i + 1]
                fit_d = fit_d + bas[:, i] * coef_d[:, i:i + 1]
            r_birth = Y - fit_b - new_col * draw[:, None]
            quad_prop = torch.where(birth, dsum(r_birth * r_birth), dsum((Y - fit_d) * (Y - fit_d)))
            ll_prop = c.half_n * (torch.log(tau) - prng.LOG_2PI) - 0.5 * tau * quad_prop
            ll_cur = c.half_n * (torch.log(tau) - prng.LOG_2PI) - 0.5 * tau * quad_cur
            log_accept = lp_prop + ll_prop + logp_rev - lp_cur - ll_cur - logp_fwd
        else:
            log_accept = lp_prop + logp_rev - lp_cur - logp_fwd
        acc = torch.log(uni(c.site_accept)) < log_accept
        kf = torch.where(acc, kf_prop, kf)
        beta = torch.where(acc[:, None], beta_p, beta)
        theta = torch.where(acc[:, None], th_p, theta)
        omega = torch.where(acc[:, None], om_p, omega)
        acc_r = acc_r + acc.to(torch.float32)
        if lik:
            # ==== 5. conjugate Gamma draw of tau, end-of-sweep log posterior ==
            quad_sel = torch.where(acc, quad_prop, quad_cur)
            lp_sel = torch.where(acc, lp_prop, lp_cur)
            tau = prng.gamma_mt(config.a_tau_star, (c.b_tau + 0.5 * quad_sel)[:, None],
                                prng.SiteStream(sites[c.g_tau.site0:]))[:, 0]
            log_tau = torch.log(tau)
            log_post = (lp_sel + c.half_n * (log_tau - prng.LOG_2PI) - 0.5 * tau * quad_sel + c.lgam_tau
                        + c.a_tau_m1 * log_tau - c.b_tau * tau)
        else:
            log_post = torch.where(acc, lp_prop, lp_cur)

        idx = store_index(it, c.n_burn, c.n_thin)
        if idx < 0:
            continue
        rows = [kf, log_post, acc_m, acc_t, acc_o, acc_r, prop_t, prop_o] + ([tau] if lik else [])
        out[:, idx, :len(rows)] = torch.stack(rows, dim=1)
        if c.stream:
            out[:, idx, len(rows):] = torch.cat([beta, theta, omega], dim=1)
    return out


# ---------------------------------------------------------------------------
# the kernel's wrapper and the runner
# ---------------------------------------------------------------------------


def _check_inputs(config: RjConfig, data, init, n_chains):
    c = config.prm
    rows = 2 if c.lik else 1
    if data.dtype != torch.float32 or not data.is_contiguous() or data.numel() != rows * c.n_data:
        raise ValueError(f"data must be a contiguous float32 tensor of {rows} x {c.n_data} values")
    if tuple(init.shape) != (n_chains, c.n_init) or init.dtype != torch.float32 or not init.is_contiguous():
        raise ValueError(f"init must be a contiguous float32 ({n_chains}, {c.n_init}) tensor, got {tuple(init.shape)}")
    if data.device != init.device:
        raise ValueError("data and init must be on one device")
    if n_chains != c.n_chains:
        raise ValueError(f"config built for {c.n_chains} chains, called with {n_chains}")


@profiling.traced("kernel.rj")
def rj_sweeps_kernel(data, init, n_chains, *, config: RjConfig):
    """Launch ``csrc/rj.cu`` on CUDA ``data`` and ``init`` (arguments and result
    as :func:`rj_sweeps_plain`). Launches on the current stream, does not
    synchronise."""
    _check_inputs(config, data, init, n_chains)
    if init.device.type != "cuda":
        raise ValueError(f"rj kernel: expected CUDA tensors, got {init.device}")
    from openmcmc_tpu_torch import _build

    c = config.prm
    npad = -(-c.n_data // LANES) * LANES
    f32 = dict(dtype=torch.float32, device=init.device)
    out = torch.empty((n_chains, c.n_keep, c.n_rows), **f32)
    # per-chain scratch: the basis columns (p x npad) and three data rows (the
    # residual and two work rows), resident in L2 at the cells' sizes
    scratch = torch.empty((n_chains, c.p + 3, npad), **f32)
    lib = _build.library()
    with torch.cuda.device(init.device):
        stream = torch.cuda.current_stream(init.device).cuda_stream
        err = lib.rj_launch(ctypes.byref(c), data.data_ptr(), init.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                            stream)
    profiling.count("launch.rj")
    _build.check(err, "rj")
    return out


def rj_sweeps(data, init, n_chains, *, config: RjConfig, bit_source=None):
    """All sweeps for all chains: the kernel for CUDA tensors, the plain version
    for CPU ones. A CUDA call launches the kernel or raises."""
    if init.device.type == "cuda":
        if bit_source is not None:
            raise ValueError("an injected bit source replaces Philox on the CPU only")
        return rj_sweeps_kernel(data, init, n_chains, config=config)
    if init.device.type != "cpu":
        raise ValueError(f"rj: unsupported device {init.device}")
    _check_inputs(config, data, init, n_chains)
    return rj_sweeps_plain(data, init, n_chains, config=config, bit_source=bit_source)


def prepare(seed, X, n_burn, n_iter, n_chains, n_max, beta0, theta0, omega0, k0, rho=8.0, mu_beta=0.0,
            tau_beta=0.25, a_omega=3.0, b_omega=2.0, theta_limits=(-10.0, 10.0), omega_rw_limits=(0.5, 2.0),
            match_limits=(-10.0, 10.0), match_scale=1.0, step_mmala=0.5, step_theta=0.1, step_omega=0.1,
            stream_params=False, n_thin=1, init=None, y=None, a_tau=2.0, b_tau=1.0, tau0=1.0, device="cuda"):
    """The kernel's inputs for :func:`run_fused_rj`'s arguments: the float32 data
    [X | y] and initial rows on ``device``, and the :class:`RjConfig`. Each
    copy to the card is one counted upload (``fused/layout.upload``), each
    read from it one counted ``to_host``."""
    X = np.asarray(to_host(X) if torch.is_tensor(X) else X, np.float32).reshape(-1)
    n_data, p, lik = X.shape[0], int(n_max), y is not None
    parts = [X]
    if lik:
        yv = np.asarray(to_host(y) if torch.is_tensor(y) else y, np.float32).reshape(-1)
        if yv.shape[0] != n_data:
            raise ValueError(f"y has {yv.shape[0]} entries but X has {n_data}")
        parts.append(yv)
    data = upload(np.concatenate(parts), device)
    nc = int(n_chains)
    if init is None:
        rows = init_rows(nc, p, beta0, theta0, omega0, float(k0), tau0 if lik else None, device=device)
    else:
        counters = init.get("counters")
        if counters is not None:
            counters = np.asarray(to_host(counters) if torch.is_tensor(counters) else counters).reshape(6, nc).T
        rows = init_rows(nc, p, init["beta"], init["theta"], init["omega"], init["k"],
                         init["tau"] if lik else None, counters, device=device)
    config = make_config(
        p, n_data, rho=rho, mu_beta=mu_beta, tau_beta=tau_beta, a_omega=a_omega, b_omega=b_omega,
        theta_limits=theta_limits, omega_rw_limits=omega_rw_limits, match_limits=match_limits,
        match_scale=match_scale, step_mmala=step_mmala, step_theta=step_theta, step_omega=step_omega,
        likelihood=lik, a_tau=a_tau, b_tau=b_tau, stream=stream_params, n_burn=int(n_burn), n_keep=int(n_iter),
        n_thin=int(n_thin), seed=seed, n_chains=nc,
    )
    return data, rows, config


def run_fused_rj(seed, X, n_burn, n_iter, n_chains, n_max, beta0, theta0, omega0, k0, *, bit_source=None, **kw):
    """The full reversible-jump run in one launch, with the JAX package's
    arguments (:func:`prepare`'s) and result.

    X: (n_data,) basis evaluation points. State is padded to ``n_max``; initial
    values broadcast over chains, or come per chain from ``init``, a dict of
    beta, theta, omega (chains, n_max), k (chains,), tau (chains,) with a
    likelihood, and optionally counters (6, chains) (the JAX warm-start form).
    ``y`` switches on the likelihood y ~ N(B beta, (tau I)^-1) with the
    conjugate Gamma(a_tau, b_tau) draw of tau (initial value tau0).
    ``device`` is the card unless the caller asks for the CPU;
    ``bit_source(sweep, site, shape)`` replaces Philox (CPU only).

    Returns n_basis and log_post (chains, n_iter), the six counters at the last
    stored sweep (accept_mmala, accept_theta, accept_omega, accept_rj,
    proposal_theta, proposal_omega; (chains,), accumulated over burn-in and
    sampling), n_proposals, tau (chains, n_iter) with a likelihood, and
    beta/theta/omega (chains, n_iter, n_max) when ``stream_params``."""
    with profiling.trace_annotated("fused.prepare"):
        data, rows, config = prepare(seed, X, n_burn, n_iter, n_chains, n_max, beta0, theta0, omega0, k0, **kw)
    draws = rj_sweeps(data, rows, int(n_chains), config=config, bit_source=bit_source)
    p, lik = config.prm.p, bool(config.prm.lik)
    out = {
        "n_basis": draws[:, :, 0],
        "log_post": draws[:, :, 1],
        "accept_mmala": draws[:, -1, 2],
        "accept_theta": draws[:, -1, 3],
        "accept_omega": draws[:, -1, 4],
        "accept_rj": draws[:, -1, 5],
        "proposal_theta": draws[:, -1, 6],
        "proposal_omega": draws[:, -1, 7],
        "n_proposals": float(n_burn + n_iter * config.prm.n_thin),
    }
    base = OUT_ROWS
    if lik:
        out["tau"] = draws[:, :, base]
        base += 1
    if config.prm.stream:
        out["beta"] = draws[:, :, base:base + p]
        out["theta"] = draws[:, :, base + p:base + 2 * p]
        out["omega"] = draws[:, :, base + 2 * p:base + 3 * p]
    return out
