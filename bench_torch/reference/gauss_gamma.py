"""Plain reference: a Gaussian latent under two Gamma-distributed scales.

    y ~ N(A x, (tau D)^-1),  x ~ N(mu, (lam P)^-1),  lam ~ Gamma(a_lam, b_lam),  tau ~ Gamma(a_tau, b_tau)

with D a positive diagonal and A the identity (the smoother) or a dense matrix
(the regression). Given (lam, tau) the posterior of x is Gaussian, so the
exact posterior is a two-dimensional integral over (log lam, log tau), taken
here by the trapezoid rule on a grid that is refined until it holds the mass
at a tenth of a standard deviation a step over twelve on each side. From it:
the posterior mean and variance of every coordinate of x and of lam and tau,
the joint log density at given draws, and exact draws (the control, computed in
a lower precision). Plain PyTorch; it imports nothing of the program and takes
only the data the benchmark made.

The generalised eigenbasis V (V'PV = I, V'A'DAV = diag(s)) makes every
conditional diagonal: with r = y - A mu and z = V'A'D r, the conditional mean
is mu + V w with w = tau z / (lam + tau s), and

    log p(y | lam, tau) = N/2 log tau + 1/2 log|D| - N/2 log 2pi
                          - tau/2 (r'Dr - 2 w'z + sum s w^2)
                          + p/2 log lam - lam/2 sum w^2 - 1/2 sum log(lam + tau s),

the residual's form taken as r'Dr - z'diag(s)^-1 z + sum lam^2 z^2 / (s (lam + tau s)^2)
so that it does not cancel where tau is large.

``precision="float64"`` is the reference. ``precision="tf32"`` is the control:
float32 throughout, every matrix product on inputs rounded to TF32's 10-bit
mantissa (round to nearest even) with float32 sums, as the card's TF32 tensor
cores compute them; the rounding is done by hand so the CPU computes it alike.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

LOG_2PI = math.log(2.0 * math.pi)
GRID_SIDE = 201        # final grid points per axis
GRID_HALF_WIDTH = 12.0  # final half-width in posterior standard deviations
REFINE_SIDE, REFINE_STEPS = 81, 8


@dataclass
class Problem:
    """The data of one fit, as the benchmark made it (any float dtype, any device)."""

    y: torch.Tensor            # (N,)
    A: Optional[torch.Tensor]  # (N, p), or None for the identity
    d: torch.Tensor            # (N,) the diagonal of D
    P: torch.Tensor            # (p, p)
    mu: torch.Tensor           # (p,)
    a_lam: float
    b_lam: float
    a_tau: float
    b_tau: float


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, round to nearest even)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Reference:
    """The exact posterior of one :class:`Problem` in the given precision."""

    def __init__(self, problem: Problem, precision: str = "float64", device="cpu"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {precision}")
        self.problem, self.precision = problem, precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.device = torch.device(device)
        f = dict(dtype=self.dtype, device=self.device)
        self.y, self.d, self.P, self.mu = (torch.as_tensor(v).to(**f) for v in (problem.y, problem.d, problem.P,
                                                                                problem.mu))
        self.A = None if problem.A is None else torch.as_tensor(problem.A).to(**f)
        self.hyper = tuple(float(v) for v in (problem.a_lam, problem.b_lam, problem.a_tau, problem.b_tau))
        self.n_obs, self.p = self.y.shape[0], self.P.shape[0]
        self.logdet_d = float(torch.sum(torch.log(self.d)))
        L = torch.linalg.cholesky(self.P)
        self.logdet_p = float(2.0 * torch.sum(torch.log(torch.diagonal(L))))
        eye = torch.eye(self.p, **f)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        r = self.y - self._apply_a(self.mu[None, :])[0]
        if self.A is None:
            G, adr = torch.diag(self.d), self.d * r
        else:
            G = self.mm(self.A.T * self.d[None, :], self.A)
            adr = self.mm((self.A.T * self.d[None, :]), r[:, None])[:, 0]
        if self.A is not None:  # the sufficient statistics of the log density's residual form
            self.G, self.ady = G, self.mm(self.A.T * self.d[None, :], self.y[:, None])[:, 0]
            self.ydy = torch.sum(self.d * self.y * self.y)
        C = self.mm(self.mm(Linv, G), Linv.T)
        s, W = torch.linalg.eigh(0.5 * (C + C.T))
        self.s = torch.clamp(s, min=0.0)
        self.V = self.mm(Linv.T, W)
        self.z = self.mm(self.V.T, adr[:, None])[:, 0]
        # r'Dr - 2 w'z + sum s w^2 = c0 + sum lam^2 z^2 / (s (lam + tau s)^2), c0 = r'Dr - sum z^2 / s >= 0:
        # no cancellation where tau is large (for the smoother, A = I, c0 is 0)
        self.s_pos = torch.clamp(self.s, min=torch.finfo(self.dtype).tiny)
        self.c0 = max(float(torch.sum(self.d * r * r) - torch.sum(self.z * self.z / self.s_pos)), 0.0)
        self._grid()

    # -- arithmetic in the chosen precision ------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            return torch.matmul(tf32(a), tf32(b))
        return torch.matmul(a, b)

    def _apply_a(self, x: torch.Tensor) -> torch.Tensor:
        """A x for rows x (n, p) -> (n, N)."""
        return x if self.A is None else self.mm(x, self.A.T)

    # -- the (log lam, log tau) posterior ---------------------------------------

    def _log_post_uv(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """log p(log lam = u, log tau = v | y) up to a constant, for (G,) points."""
        a_lam, b_lam, a_tau, b_tau = self.hyper
        lam, tau = torch.exp(u)[:, None], torch.exp(v)[:, None]
        denom = lam + tau * self.s[None, :]
        w = tau * self.z[None, :] / denom
        quad_y = self.c0 + torch.sum((lam * self.z[None, :] / denom) ** 2 / self.s_pos[None, :], 1)
        out = (0.5 * self.n_obs * v - 0.5 * tau[:, 0] * quad_y + 0.5 * self.p * u
               - 0.5 * lam[:, 0] * torch.sum(w * w, 1) - 0.5 * torch.sum(torch.log(denom), 1))
        # Gamma priors on lam and tau, and the Jacobians of the log transforms
        return out + a_lam * u - b_lam * lam[:, 0] + a_tau * v - b_tau * tau[:, 0]

    def _weights(self, uc, vc, hu, hv, side):
        f = dict(dtype=self.dtype, device=self.device)
        u1 = torch.linspace(uc - hu, uc + hu, side, **f)
        v1 = torch.linspace(vc - hv, vc + hv, side, **f)
        u, v = torch.meshgrid(u1, v1, indexing="ij")
        u, v = u.reshape(-1), v.reshape(-1)
        lp = torch.cat([self._log_post_uv(u[i : i + 8192], v[i : i + 8192]) for i in range(0, u.shape[0], 8192)])
        w = torch.exp(lp - torch.max(lp))
        return u, v, w / torch.sum(w), float(u1[1] - u1[0]), float(v1[1] - v1[0])

    def _grid(self):
        """Refine a grid in (log lam, log tau) from a wide start until it is
        centred on the mass, then lay the final grid at +-12 sd."""
        uc, vc, hu, hv = 0.0, 0.0, 20.0, 20.0
        for _ in range(REFINE_STEPS):
            u, v, w, du, dv = self._weights(uc, vc, hu, hv, REFINE_SIDE)
            uc, vc = float(torch.sum(w * u)), float(torch.sum(w * v))
            su = math.sqrt(max(float(torch.sum(w * (u - uc) ** 2)), 0.0))
            sv = math.sqrt(max(float(torch.sum(w * (v - vc) ** 2)), 0.0))
            hu, hv = max(GRID_HALF_WIDTH * su, 3.0 * du), max(GRID_HALF_WIDTH * sv, 3.0 * dv)
        self.u, self.v, self.w, self.du, self.dv = self._weights(uc, vc, hu, hv, GRID_SIDE)
        self.lam, self.tau = torch.exp(self.u), torch.exp(self.v)

    # -- what the check compares -------------------------------------------------

    def at(self, precision: str) -> "Reference":
        """The same posterior in another precision."""
        return Reference(self.problem, precision, self.device)

    def moments(self) -> dict:
        """Posterior mean and variance of x's coordinates, lam and tau: {name: (mean (k,), var (k,))}."""
        w, lam, tau = self.w, self.lam, self.tau
        out = {}
        for name, val in (("lam", lam), ("tau", tau)):
            m = torch.sum(w * val)
            out[name] = (m.reshape(1), torch.sum(w * (val - m) ** 2).reshape(1))
        mean_w = torch.zeros(self.p, dtype=self.dtype, device=self.device)
        cond_var = torch.zeros(self.p, dtype=self.dtype, device=self.device)
        for i in range(0, w.shape[0], 4096):
            sl = slice(i, i + 4096)
            denom = lam[sl, None] + tau[sl, None] * self.s[None, :]
            mean_w += torch.sum(w[sl, None] * tau[sl, None] * self.z[None, :] / denom, 0)
            cond_var += torch.sum(w[sl, None] / denom, 0)
        mean_x = self.mm(self.V, mean_w[:, None])[:, 0]
        var_x = self.mm(self.V * self.V, cond_var[:, None])[:, 0]
        for i in range(0, w.shape[0], 4096):
            sl = slice(i, i + 4096)
            denom = lam[sl, None] + tau[sl, None] * self.s[None, :]
            dev = self.mm(tau[sl, None] * self.z[None, :] / denom, self.V.T) - mean_x[None, :]
            var_x += torch.sum(w[sl, None] * dev * dev, 0)
        out["x"] = (self.mu + mean_x, var_x)
        return out

    def log_density(self, x: torch.Tensor, lam: torch.Tensor, tau: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
        """log p(y, x, lam, tau) at n draws (x (n, p), lam and tau (n,)), with every
        normalising constant, as ``Model.log_p`` defines it. The regression's
        residual form comes from the sufficient statistics A'DA, A'Dy and y'Dy
        (exact to about 1e-10 relative in float64)."""
        a_lam, b_lam, a_tau, b_tau = self.hyper
        out = []
        for i in range(0, x.shape[0], block):
            xs = x[i : i + block].to(self.device, self.dtype)
            ls = lam[i : i + block].to(self.device, self.dtype)
            ts = tau[i : i + block].to(self.device, self.dtype)
            dx = xs - self.mu[None, :]
            if self.A is None:
                resid = self.y[None, :] - xs
                quad_y = torch.sum(self.d[None, :] * resid * resid, 1)
            else:  # y'Dy - 2 x'A'Dy + x'A'DAx, as the program's engines take it
                quad_y = (self.ydy - 2.0 * self.mm(xs, self.ady[:, None])[:, 0]
                          + torch.sum(self.mm(xs, self.G) * xs, 1))
            quad_x = torch.sum(self.mm(dx, self.P) * dx, 1)
            lp = (0.5 * (self.n_obs * torch.log(ts) + self.logdet_d - self.n_obs * LOG_2PI - ts * quad_y)
                  + 0.5 * (self.p * torch.log(ls) + self.logdet_p - self.p * LOG_2PI - ls * quad_x))
            for val, a, b in ((ls, a_lam, b_lam), (ts, a_tau, b_tau)):
                lp = lp + (a - 1.0) * torch.log(val) - b * val + a * math.log(b) - math.lgamma(a)
            out.append(lp)
        return torch.cat(out)

    def sample(self, n: int, generator: torch.Generator, block: int = 1 << 18) -> dict:
        """n exact posterior draws: a grid point by its weight, jittered uniformly
        over its cell, then x from its Gaussian conditional. {"x": (n, p),
        "lam": (n,), "tau": (n,)} in this precision."""
        f = dict(dtype=self.dtype, device=self.device)
        xs, lams, taus = [], [], []
        for i in range(0, n, block):
            m = min(block, n - i)
            idx = torch.multinomial(self.w.to(torch.float64), m, replacement=True, generator=generator)
            u = self.u[idx] + (torch.rand(m, generator=generator, **f) - 0.5) * self.du
            v = self.v[idx] + (torch.rand(m, generator=generator, **f) - 0.5) * self.dv
            lam, tau = torch.exp(u), torch.exp(v)
            denom = lam[:, None] + tau[:, None] * self.s[None, :]
            eps = torch.randn((m, self.p), generator=generator, **f)
            w = tau[:, None] * self.z[None, :] / denom + eps / torch.sqrt(denom)
            xs.append(self.mu[None, :] + self.mm(w, self.V.T))
            lams.append(lam)
            taus.append(tau)
        return {"x": torch.cat(xs), "lam": torch.cat(lams), "tau": torch.cat(taus)}
