"""Plain reference: the prior of the reversible-jump knot basis.

    k ~ Poisson(rho) restricted to 1..n_max, and for j < k:
    theta_j ~ U(lo, hi), omega_j ~ Gamma(a, b), beta_j ~ N(mu, 1 / tau)

With a Null likelihood the posterior is this prior. From it: the count's exact
mean and variance (the [1, n_max]-truncated Poisson), the joint log density of
a padded state (entries from k on are not read; the count's term is
Poisson's, whose truncation adds the same constant to every draw, as the
program states it), and exact draws (a Gamma of whole shape a as a sum of a
exponentials). Plain PyTorch; it imports nothing of the program.

``precision="float64"`` is the reference. ``precision="tf32"`` is the
control: float32 throughout, every input of the log density rounded to TF32's
10-bit mantissa (``gauss_gamma.tf32``), its sums in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from bench_torch.reference.gauss_gamma import tf32


@dataclass
class Prior:
    """The configuration's hyperparameters."""

    n_max: int
    rho: float
    lo: float
    hi: float
    mu: float
    tau: float
    a: float
    b: float

    @classmethod
    def of(cls, cfg: dict) -> "Prior":
        return cls(cfg["n_max"], cfg["rho"], *cfg["theta_limits"], cfg["mu_beta"], cfg["tau_beta"], cfg["a_omega"],
                   cfg["b_omega"])


class Reference:
    """The prior in the given precision."""

    def __init__(self, prior: Prior, precision: str = "float64", device="cpu"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {precision}")
        self.prior, self.precision, self.device = prior, precision, torch.device(device)
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        ks = torch.arange(1, prior.n_max + 1, dtype=torch.float64)
        log_pmf = ks * math.log(prior.rho) - torch.lgamma(ks + 1.0)
        self.pmf = torch.softmax(log_pmf, 0)  # over 1..n_max

    def at(self, precision: str) -> "Reference":
        return Reference(self.prior, precision, self.device)

    def count_moments(self) -> tuple:
        """The exact mean and variance of the count."""
        ks = torch.arange(1, self.prior.n_max + 1, dtype=torch.float64)
        mean = float(torch.sum(ks * self.pmf))
        return mean, float(torch.sum((ks - mean) ** 2 * self.pmf))

    def log_density(self, k, beta, theta, omega) -> torch.Tensor:
        """The joint log density of each padded state: k (...,), beta, theta and
        omega (..., n_max); -inf where an active theta lies outside [lo, hi] or
        an active omega is not positive."""
        c, f = self.prior, dict(dtype=self.dtype, device=self.device)
        rnd = tf32 if self.precision == "tf32" else (lambda t: t)
        kf = k.reshape(-1).to(**f)
        beta, theta, omega = (rnd(v.reshape(kf.shape[0], -1).to(**f)) for v in (beta, theta, omega))
        m = torch.arange(c.n_max, device=self.device)[None, :] < kf[:, None]
        om = torch.where(m, omega, torch.ones((), **f))
        terms = (0.5 * math.log(c.tau / (2.0 * math.pi)) - 0.5 * c.tau * (beta - c.mu) ** 2
                 + (c.a - 1.0) * torch.log(om) - c.b * om + c.a * math.log(c.b) - math.lgamma(c.a))
        lp = (kf * math.log(c.rho) - c.rho - torch.lgamma(kf + 1.0) - kf * math.log(c.hi - c.lo)
              + torch.sum(torch.where(m, terms, torch.zeros((), **f)), 1))
        outside = torch.any(m & ((theta < c.lo) | (theta > c.hi) | (omega <= 0.0)), 1)
        return torch.where(outside, torch.full_like(lp, -math.inf), lp)

    def sample(self, n: int, generator: torch.Generator) -> dict:
        """``n`` exact draws: k (n,) int32, beta, theta, omega (n, n_max), zero
        from k on."""
        c, f = self.prior, dict(dtype=self.dtype, device=self.device)
        if c.a != int(c.a) or c.a < 1:
            raise ValueError(f"exact Gamma draws need a whole shape, got {c.a}")
        cdf = torch.cumsum(self.pmf, 0).to(self.device)
        u = torch.rand(n, generator=generator, dtype=torch.float64, device=self.device)
        k = torch.clamp(torch.searchsorted(cdf, u, right=True) + 1, max=c.n_max)
        m = torch.arange(c.n_max, device=self.device)[None, :] < k[:, None]
        beta = c.mu + torch.randn(n, c.n_max, generator=generator, **f) / math.sqrt(c.tau)
        theta = c.lo + (c.hi - c.lo) * torch.rand(n, c.n_max, generator=generator, **f)
        uni = torch.rand(int(c.a), n, c.n_max, generator=generator, **f)
        omega = -torch.sum(torch.log1p(-uni), 0) / c.b
        zero = torch.zeros((), **f)
        return {"k": k.to(torch.int32), "beta": torch.where(m, beta, zero), "theta": torch.where(m, theta, zero),
                "omega": torch.where(m, omega, zero)}
