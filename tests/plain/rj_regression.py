"""Plain reference of the reversible-jump knot-basis regression.

The model is the fixture of sede-open/openMCMC's tests/test_reversible_jump.py
(``fix_state``, ``fix_model``, ``fix_samplers``) with its Null response
replaced by data, y ~ N(B beta, (tau_y I)^-1):

    k        ~ Poisson(rho) on 1..n_max                     (active knots)
    theta_j  ~ U(lo, hi),  omega_j ~ Gamma(a_omega, b_omega),
    beta_j   ~ N(mu_beta, 1 / tau_beta)                      (j < k)
    tau_y    ~ Gamma(a_tau, b_tau)
    B[:, j]  = normpdf(X; theta_j, omega_j)

It holds two things, each independent of the program under test:

(a) :func:`log_density`, the joint log density of a padded stored state
    (k, beta, theta, omega, tau_y) given X and y: the Gaussian likelihood, the
    Poisson term of the count, and the uniform, Gamma and Normal priors of the
    active entries and the Gamma prior of tau_y. Entries from k on are not read.
    The count's term is Poisson's: its truncation to 1..n_max adds one constant
    to every state, and the program states it so too.
(b) :func:`sample`, a sampler of the same posterior, vectorised over chains with
    masks. Its moves are not the reference's:

    - beta is integrated out given (k, theta, omega, tau_y): every move of the
      knots accepts on the marginal likelihood (a Cholesky of the k x k
      posterior precision tau_y B'B + tau_beta I), where the reference moves
      beta by manifold MALA and matches its coefficients on birth and death;
    - birth draws (theta, omega) of a new knot from their prior, death removes
      a uniformly chosen knot (the last active one takes its place), both
      accepting on the marginal likelihood and the count's prior, where the
      reference matches the fitted values across the jump;
    - a knot's (theta, omega) move together, by a coin's throw either by a
      random walk, theta by a normal step (a proposal outside [lo, hi] is
      rejected) and log omega by a normal step (its Jacobian in the ratio),
      with no box on omega, or by a redraw from their prior (an independence
      move the reference lacks), where the reference walks theta and omega
      apart, truncated to [lo, hi] and to its omega box [0.5, 2];
    - then beta is drawn from its Gaussian conditional and tau_y from its Gamma
      conditional (a whole or half-whole shape, as a sum of exponentials and
      half a squared normal).

    Both samplers leave the same posterior invariant. The reference's omega
    walk proposes only inside its box [0.5, 2], and a birth draws omega from
    Gamma(a_omega, b_omega), so a width outside the box occurs. Such a width is
    never moved by the walk: its reverse proposal density, the truncated normal
    on the box at a point outside it, is 0 (the program's ``truncnorm_logpdf``
    returns -inf there, in ``fused/prng.py`` and ``csrc/prng.cuh``), so the
    proposal is rejected whatever it is. The walk's kernel is then the
    Metropolis-Hastings kernel of the posterior restricted to the box for a
    width inside it and the identity for one outside it: each is reversible
    with respect to the posterior, and no move crosses the box's edge, so the
    posterior stays invariant. Widths outside the box are made and removed by
    birth and death alone, in both samplers.

``precision="float64"`` is the reference. ``precision="tf32"`` is the control:
float32 throughout, TF32 matrix products on the card, and every input of the
log density rounded to TF32's 10-bit mantissa (so that the CPU, which has no
TF32, computes the same control). Plain PyTorch: it imports neither JAX nor
any module of the program.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_LOG_2PI = math.log(2.0 * math.pi)
PRECISIONS = ("float64", "tf32")


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, round to nearest even)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """TF32 matrix products inside the block for the control, none otherwise."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@dataclass
class Problem:
    """The data and the hyperparameters."""

    X: torch.Tensor  # (n,)
    y: torch.Tensor  # (n,)
    n_max: int
    rho: float
    lo: float
    hi: float
    mu_beta: float
    tau_beta: float
    a_omega: float
    b_omega: float
    a_tau: float
    b_tau: float


def _dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision}")
    return torch.float64 if precision == "float64" else torch.float32


def basis(X, theta, omega, mask):
    """(..., n, n_max): normpdf(X; theta_j, omega_j) in the active columns, 0 in
    the others (an inactive width is read as 1)."""
    om = torch.where(mask, omega, torch.ones_like(omega))
    z = (X[..., :, None] - theta[..., None, :]) / om[..., None, :]
    return torch.exp(-0.5 * z * z) / (om[..., None, :] * math.sqrt(2.0 * math.pi)) * mask[..., None, :]


def log_density(problem: Problem, k, beta, theta, omega, tau, precision: str = "float64", chunk: int = 1 << 16):
    """The joint log density of each stored state: k (N,), beta, theta, omega
    (N, n_max), tau (N,); -inf where an active theta lies outside [lo, hi], an
    active omega or tau is not positive. Computed ``chunk`` states at a time."""
    c, dtype = problem, _dtype(precision)
    rnd = tf32 if precision == "tf32" else (lambda t: t)
    dev = problem.X.device
    X, y = (rnd(v.to(dev, dtype)) for v in (problem.X, problem.y))
    n = X.shape[0]
    idx = torch.arange(c.n_max, device=dev)
    const = (c.a_omega * math.log(c.b_omega) - math.lgamma(c.a_omega) + 0.5 * math.log(c.tau_beta)
             - 0.5 * _LOG_2PI)
    out = []
    for s in range(0, k.reshape(-1).shape[0], chunk):
        kk = k.reshape(-1)[s:s + chunk].to(dev)
        b, th, om = (rnd(v.reshape(-1, c.n_max)[s:s + chunk].to(dev, dtype)) for v in (beta, theta, omega))
        t = rnd(tau.reshape(-1)[s:s + chunk].to(dev, dtype))
        kf = kk.to(dtype)
        m = idx[None, :] < kk[:, None]
        om_safe = torch.where(m, om, torch.ones_like(om))
        terms = (const - 0.5 * c.tau_beta * (b - c.mu_beta) ** 2 + (c.a_omega - 1.0) * torch.log(om_safe)
                 - c.b_omega * om_safe)
        prior = (kf * math.log(c.rho) - c.rho - torch.lgamma(kf + 1.0) - kf * math.log(c.hi - c.lo)
                 + torch.sum(torch.where(m, terms, torch.zeros_like(terms)), 1))
        with _matmul_precision(precision):
            fit = (basis(X, th, om, m) @ torch.where(m, b, torch.zeros_like(b))[:, :, None])[..., 0]
        resid = y[None, :] - fit
        t_safe = torch.where(t > 0, t, torch.ones_like(t))
        lik = 0.5 * n * (torch.log(t_safe) - _LOG_2PI) - 0.5 * t_safe * torch.sum(resid * resid, 1)
        tau_prior = (c.a_tau * math.log(c.b_tau) - math.lgamma(c.a_tau) + (c.a_tau - 1.0) * torch.log(t_safe)
                     - c.b_tau * t_safe)
        lp = prior + lik + tau_prior
        bad = torch.any(m & ((th < c.lo) | (th > c.hi) | (om <= 0.0)), 1) | (t <= 0.0)
        out.append(torch.where(bad, torch.full_like(lp, -math.inf), lp))
    return torch.cat(out)


def _gamma_whole(shape: float, size, generator, dtype, device):
    """Gamma(shape, 1) draws for a whole or half-whole shape: a sum of
    exponentials, plus half a squared normal for the half."""
    twice = 2.0 * shape
    if twice != int(twice) or shape <= 0:
        raise ValueError(f"exact Gamma draws need a whole or half-whole shape, got {shape}")
    whole = int(shape)
    g = torch.zeros(size, dtype=dtype, device=device)
    if whole:
        u = torch.rand((whole, *size), generator=generator, dtype=dtype, device=device)
        g = -torch.sum(torch.log1p(-u), 0)
    if int(twice) % 2:
        z = torch.randn(size, generator=generator, dtype=dtype, device=device)
        g = g + 0.5 * z * z
    return g


class _Chains:
    """The sampler's state over C chains, with the marginal likelihood of each
    chain's knots, the Cholesky factor L of beta's posterior precision and
    w = L^-1 (tau_y B'y + tau_beta mu_beta), kept for the current state."""

    def __init__(self, problem: Problem, chains: int, generator, dtype):
        c = problem
        self.c, self.gen, self.dtype, self.dev = c, generator, dtype, problem.X.device
        self.X, self.y = c.X.to(self.dev, dtype), c.y.to(self.dev, dtype)
        self.n, self.C = self.X.shape[0], chains
        self.idx = torch.arange(c.n_max, device=self.dev)
        self.yy = torch.sum(self.y * self.y)
        # an overdispersed start: the count and the knots from their priors,
        # tau_y at its prior mean, beta integrated out
        self.k = self.poisson_start()
        self.th = self.uniform_theta((chains, c.n_max))
        self.om = self.gamma_omega((chains, c.n_max))
        self.tau = torch.full((chains,), c.a_tau / c.b_tau, dtype=dtype, device=self.dev)
        self.ll, self.L, self.w = self.marginal(self.k, self.th, self.om)

    def rand(self, *size):
        return torch.rand(size, generator=self.gen, dtype=self.dtype, device=self.dev)

    def randn(self, *size):
        return torch.randn(size, generator=self.gen, dtype=self.dtype, device=self.dev)

    def poisson_start(self):
        """Counts from the Poisson(rho) restricted to 1..n_max, by inversion."""
        ks = torch.arange(1, self.c.n_max + 1, dtype=torch.float64, device=self.dev)
        cdf = torch.cumsum(torch.softmax(ks * math.log(self.c.rho) - torch.lgamma(ks + 1.0), 0), 0)
        u = torch.rand(self.C, generator=self.gen, dtype=torch.float64, device=self.dev)
        return torch.clamp(torch.searchsorted(cdf, u, right=True) + 1, 1, self.c.n_max)

    def uniform_theta(self, size):
        return self.c.lo + (self.c.hi - self.c.lo) * self.rand(*size)

    def gamma_omega(self, size):
        return _gamma_whole(self.c.a_omega, size, self.gen, self.dtype, self.dev) / self.c.b_omega

    def mask(self, k):
        return self.idx[None, :] < k[:, None]

    def marginal(self, k, th, om):
        """log p(y | k, theta, omega, tau_y) with beta integrated out, and L, w."""
        c, m = self.c, self.mask(k)
        B = basis(self.X, th, om, m)
        Bt = B.transpose(1, 2)
        t = self.tau
        mf = m.to(self.dtype)
        Q = t[:, None, None] * (Bt @ B)
        Q.diagonal(dim1=1, dim2=2).add_(c.tau_beta * mf + (1.0 - mf))
        rhs = t[:, None, None] * (Bt @ self.y[None, :, None]) + (c.tau_beta * c.mu_beta) * mf[:, :, None]
        L, _ = torch.linalg.cholesky_ex(Q)
        w = torch.linalg.solve_triangular(L, rhs, upper=False)[..., 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), 1)
        kf = k.to(self.dtype)
        ll = (0.5 * self.n * (torch.log(t) - _LOG_2PI) + 0.5 * kf * math.log(c.tau_beta) - 0.5 * logdet
              - 0.5 * (t * self.yy + kf * (c.tau_beta * c.mu_beta ** 2) - torch.sum(w * w, 1)))
        return ll, L, w

    def accept(self, log_alpha, k, th, om):
        """Metropolis-Hastings: each chain takes the proposal with probability
        min(1, exp(log_alpha + its marginal less the current one))."""
        ll, L, w = self.marginal(k, th, om)
        ok = torch.log(self.rand(self.C)) < log_alpha + ll - self.ll
        self.k = torch.where(ok, k, self.k)
        self.th = torch.where(ok[:, None], th, self.th)
        self.om = torch.where(ok[:, None], om, self.om)
        self.ll = torch.where(ok, ll, self.ll)
        self.L = torch.where(ok[:, None, None], L, self.L)
        self.w = torch.where(ok[:, None], w, self.w)

    def pick(self):
        """One active knot of each chain, uniformly: a (C, n_max) one-hot mask."""
        j = torch.floor(self.rand(self.C) * self.k.to(self.dtype)).long()
        return self.idx[None, :] == torch.minimum(j, self.k - 1)[:, None]

    def move(self, s_theta: float, s_log_omega: float):
        """One knot of each chain moves, by a coin's throw: a walk (theta by a
        normal step, log omega by another; the Gamma prior of omega and the log
        step's Jacobian in the ratio, a theta outside [lo, hi] rejected) or a
        redraw of its (theta, omega) from their prior (the priors cancel)."""
        c, sel = self.c, self.pick()
        size = (self.C, c.n_max)
        walk = (self.rand(self.C) < 0.5)[:, None]
        th_w = self.th + s_theta * self.randn(*size)
        om_w = self.om * torch.exp(s_log_omega * self.randn(*size))
        th = torch.where(sel, torch.where(walk, th_w, self.uniform_theta(size)), self.th)
        om = torch.where(sel, torch.where(walk, om_w, self.gamma_omega(size)), self.om)
        log_g = c.a_omega * (torch.log(om) - torch.log(self.om)) - c.b_omega * (om - self.om)
        ratio = torch.where(sel & walk, log_g, 0.0)
        outside = torch.any(sel & ((th < c.lo) | (th > c.hi)), 1)
        self.accept(torch.where(outside, -math.inf, torch.sum(ratio, 1)), self.k, th, om)

    def jump(self):
        """Birth (a knot from the prior at position k) or death (a uniform knot,
        replaced by the last active one), on the unordered set of knots: the
        ratio is the marginal likelihoods' and the counts' priors' times the
        moves' probabilities, the new knot's prior cancelling its proposal."""
        c, k = self.c, self.k
        kf = k.to(self.dtype)
        p_birth = torch.where(kf <= 1.0, 1.0, torch.where(kf >= c.n_max, 0.0, 0.5))
        birth = self.rand(self.C) < p_birth
        at_k = self.idx[None, :] == k[:, None]
        size = (self.C, c.n_max)
        th_b = torch.where(at_k, self.uniform_theta(size), self.th)
        om_b = torch.where(at_k, self.gamma_omega(size), self.om)
        sel, last = self.pick(), self.idx[None, :] == (k - 1)[:, None]

        def remove(v):
            moved_in = torch.where(sel, torch.sum(torch.where(last, v, 0.0), 1, keepdim=True), v)
            return torch.where(last, 0.0, moved_in)

        # the other move's probability from the state it leads to: death from k + 1
        # (certain at n_max, else one half); birth from k - 1 (certain at 1)
        p_death_up = torch.where(kf + 1.0 >= c.n_max, 1.0, 0.5)
        p_birth_down = torch.where(kf - 1.0 <= 1.0, 1.0, 0.5)
        log_b = math.log(c.rho) - torch.log(kf + 1.0) + torch.log(p_death_up) - torch.log(p_birth)
        log_d = -math.log(c.rho) + torch.log(kf) + torch.log(p_birth_down) - torch.log(1.0 - p_birth)
        th = torch.where(birth[:, None], th_b, remove(self.th))
        om = torch.where(birth[:, None], om_b, remove(self.om))
        self.accept(torch.where(birth, log_b, log_d), torch.where(birth, k + 1, k - 1), th, om)

    def draw_beta_tau(self):
        """beta from its Gaussian conditional, beta = L^-T (w + z), then tau_y
        from its Gamma one; the marginal is recomputed at the new tau_y."""
        c, m = self.c, self.mask(self.k)
        z = self.w + self.randn(self.C, c.n_max)
        beta = torch.linalg.solve_triangular(self.L.transpose(1, 2), z[..., None], upper=True)[..., 0]
        beta = torch.where(m, beta, 0.0)
        fit = (basis(self.X, self.th, self.om, m) @ beta[:, :, None])[..., 0]
        resid = self.y[None, :] - fit
        rate = c.b_tau + 0.5 * torch.sum(resid * resid, 1)
        self.tau = _gamma_whole(c.a_tau + 0.5 * self.n, (self.C,), self.gen, self.dtype, self.dev) / rate
        self.ll, self.L, self.w = self.marginal(self.k, self.th, self.om)
        return beta


def _graphed(sweep, s: _Chains):
    """One sweep run on a side stream, then ``sweep`` captured as a CUDA graph:
    the chains' state becomes fixed buffers that each replay reads and
    overwrites, the generator registered so that each replay draws anew. A
    sweep is some 300 small operations, whose launches cost the host more time
    than the card. Returns the replay (it returns beta's buffer) and the first
    sweep's beta."""
    names = ("k", "th", "om", "tau", "ll", "L", "w")
    side = torch.cuda.Stream(s.dev)
    side.wait_stream(torch.cuda.current_stream(s.dev))
    with torch.cuda.stream(side):
        first = sweep()
    torch.cuda.current_stream(s.dev).wait_stream(side)
    bufs = {name: getattr(s, name).clone() for name in names}
    for name in names:
        setattr(s, name, bufs[name])
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(s.gen)
    with torch.cuda.graph(graph):
        beta = sweep()
        for name in names:
            bufs[name].copy_(getattr(s, name))
            setattr(s, name, bufs[name])

    def replay():
        graph.replay()
        return beta

    return replay, first


def sample(problem: Problem, chains: int, burn: int, sweeps: int, generator: torch.Generator,
           precision: str = "float64", full: bool = False, s_theta: float = 0.2, s_log_omega: float = 0.2) -> dict:
    """``sweeps`` stored sweeps of ``chains`` chains after ``burn`` sweeps from an
    overdispersed start. A sweep: one knot moved, a birth or death, another
    knot moved, then beta and tau_y; on the card, every sweep after the first
    is one CUDA graph's replay. Returns k (chains, sweeps) int32 and tau
    (chains, sweeps); with ``full``, beta, theta and omega (chains, sweeps,
    n_max) too, zero from k on."""
    dtype = _dtype(precision)
    out = {"k": [], "tau": []} | ({"beta": [], "theta": [], "omega": []} if full else {})
    with _matmul_precision(precision):
        s = _Chains(problem, chains, generator, dtype)

        def sweep():
            s.move(s_theta, s_log_omega)
            s.jump()
            s.move(s_theta, s_log_omega)
            return s.draw_beta_tau()

        step = sweep
        for it in range(burn + sweeps):
            if it == 0 and s.dev.type == "cuda":
                step, beta = _graphed(sweep, s)
            else:
                beta = step()
            if it < burn:
                continue
            out["k"].append(s.k.to(torch.int32))
            out["tau"].append(s.tau.clone())
            if full:
                m = s.mask(s.k)
                out["beta"].append(beta.clone())
                out["theta"].append(torch.where(m, s.th, 0.0))
                out["omega"].append(torch.where(m, s.om, 0.0))
    return {name: torch.stack(v, 1) for name, v in out.items()}
