"""GMRF precision builders and Gaussian samplers (port of ``openmcmc_tpu/linalg/gmrf.py``).

Ported so far: :func:`precision_irregular` (the RW1 prior of the flagship
smoother), :func:`sample_normal`, :func:`sample_normal_canonical`,
:func:`mvn_log_pdf`, and the box-truncated machinery of the generic driver
(:func:`truncated_normal_rv`, the red-black schedule of
:func:`gibbs_canonical_truncated_normal`, :func:`sample_truncated_normal_rejection`,
:func:`sample_truncated_normal`) and the truncated proposal density of the
random walk (:func:`truncated_normal_log_pdf`), all chain-batched through leading
axes (see :mod:`openmcmc_tpu_torch.linalg.structured`). The lexicographic
truncated schedule and ``Permuted`` precisions are not ported yet (ROADMAP.md
queue 1: sparse and permuted priors); ``precision_temporal`` comes with the
examples (queue 1: examples and entry).

Randomness: where the JAX package takes a key, the port takes a :class:`Key`,
the run's ``torch.Generator`` plus the Philox key and call counter of kernel
draws. Truncated draws take their uniforms from the generator, and ``torch.erf``
stands for ``lax.erf``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.linalg import tridiag
from openmcmc_tpu_torch.linalg.random import fast_erfinv

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT2 = 1.4142135623730951
_SPARSE_ITEM = "ROADMAP.md queue 1: sparse and permuted priors"


@dataclasses.dataclass(frozen=True)
class Key:
    """The random streams of one draw: the port's counterpart of a JAX key.

    ``generator`` is the run's ``torch.Generator`` on the driver's device, for
    torch draws. ``seed`` and ``counter`` are host integers: the Philox key and
    call counter of kernel draws (K3), unique per (sweep, sampler) within a run,
    so that no draw reads a value back from the card."""

    generator: torch.Generator
    seed: int = 0
    counter: int = 0


def precision_irregular(s, banded: bool = True, device=None):
    """First-order random-walk precision for irregular locations ``s``.

    Q_ii = 1/del_{i-1} + 1/del_i (one term at the ends); Q_{i,i+1} = -1/del_i.
    Returns a Banded (bw = 1) matrix, or a dense (p, p) tensor with
    ``banded=False``. Float32, like the JAX package without x64."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device).reshape(-1)
    if s.shape[0] <= 1:
        one = torch.ones((1, 1), dtype=s.dtype, device=s.device)
        return st.Banded(one) if banded else one
    dr = 1.0 / torch.diff(s)
    d0 = torch.cat([dr[:1], dr[:-1] + dr[1:], dr[-1:]])
    if banded:
        off = torch.cat([-dr, torch.zeros((1,), dtype=s.dtype, device=s.device)])
        return st.Banded(torch.stack([d0, off]))
    return torch.diag(d0) - torch.diag(dr, -1) - torch.diag(dr, 1)


def _as_chol(Q, L) -> st.Structured:
    if L is not None:
        return L
    return st.cholesky(st.as_structured(Q))


def sample_normal(key: Key, mu, Q=None, L=None, n: int = 1, batch_shape=()) -> torch.Tensor:
    """x ~ N(mu, Q^-1) by Rue & Held Alg. 2.4: x = mu + L^-T z, L the lower
    Cholesky factor of the precision Q (ignored when L is given).

    ``mu`` is (p,), (p, m) or (..., p, m). The draw is (..., p, n), its batch the
    broadcast of ``batch_shape``, mu's and the factor's batch axes: every batch
    element draws its own z."""
    chol = _as_chol(Q, L)
    mu = torch.as_tensor(mu)
    p = st.dim(chol)
    if mu.dim() < 2:
        mu = mu.reshape(p, -1)
    batch = torch.broadcast_shapes(tuple(batch_shape), mu.shape[:-2], st.batch_shape(chol))
    dtype = mu.dtype if mu.dtype.is_floating_point else torch.float32
    z = torch.randn(batch + (p, n), generator=key.generator, dtype=dtype, device=mu.device)
    return st.solve_upper_t(chol, z) + mu


def sample_normal_canonical(key: Key, b, Q=None, L=None) -> torch.Tensor:
    """x ~ N(Q^-1 b, Q^-1) by Rue & Held Alg. 2.5; b is (p,), (p, n) or (..., p, n),
    and a (p,) b draws a (p, 1) column, as in the JAX package.

    A tridiagonal Banded Q with a single column b goes to kernel K3 (on CUDA
    tensors; its plain version on CPU tensors), every batch element one chain of
    the draw. Everything else factors Q once and reuses the factor: mu =
    Q^-1 b by two triangular solves, then :func:`sample_normal`."""
    b = torch.as_tensor(b)
    if L is None and isinstance(Q, st.Banded) and Q.bw == 1 and (b.dim() == 1 or b.shape[-1] == 1):
        p = st.dim(Q)
        rhs = b.reshape(b.shape[:-2] + (p,)) if b.dim() >= 2 else b
        batch = torch.broadcast_shapes(rhs.shape[:-1], Q.bands.shape[:-2])
        a, c, rhs = (t.expand(batch + (p,)).reshape(-1, p) for t in (Q.bands[..., 0, :], Q.bands[..., 1, :], rhs))
        x = tridiag.sample_canonical_tridiag(key.seed, key.counter, a, c, rhs)
        return x.reshape(batch + (p, 1))
    chol = _as_chol(Q, L)
    mu = st.cho_solve(chol, b)
    return sample_normal(key, mu, L=chol)


def mvn_log_pdf(x, mu, Q=None, L=None, by_observation: bool = False) -> torch.Tensor:
    """log N(x; mu, Q^-1) in precision form:
    1/2 (log|Q| - d log 2 pi - ||L^T (x - mu)||^2), per replicate column, summed
    unless ``by_observation``. x is (d,), (d, n) or (..., d, n); the result keeps
    the batch axes."""
    chol = _as_chol(Q, L)
    x = torch.as_tensor(x)
    mu = torch.as_tensor(mu)
    vec = x.dim() == 1
    d = x.shape[0] if vec else x.shape[-2]
    xr = x[:, None] if vec else x
    r = xr - (mu if mu.dim() >= 2 else mu.reshape(d, -1))
    w = st.chol_matvec_t(chol, r)
    quad = torch.sum(w * w, dim=-2)
    log_p = 0.5 * (st.chol_log_det(chol)[..., None] - d * _LOG_2PI - quad)
    if vec:
        return log_p[..., 0]
    return log_p if by_observation else torch.sum(log_p, dim=-1)


# ---------------------------------------------------------------------------
# Box-truncated Gaussians
# ---------------------------------------------------------------------------


def _bound_column(bound, p: int, fill: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (p,)-shaped bound as a (p, 1) column on ``like``'s device and
    dtype; ``None`` is the open side ``fill`` (+-inf)."""
    if bound is None:
        return torch.full((p, 1), fill, dtype=like.dtype, device=like.device)
    return torch.as_tensor(bound, dtype=like.dtype, device=like.device).reshape(-1, 1).expand(p, 1)


def _standardize_bounds(mean, scale, lower, upper):
    lower = -math.inf if lower is None else lower
    upper = math.inf if upper is None else upper
    return (lower - mean) / scale, (upper - mean) / scale


def truncated_normal_rv(key: Key, mean, scale, lower=None, upper=None, shape=None, u=None) -> torch.Tensor:
    """Truncated-normal draws on [lower, upper], elementwise broadcast (inverse CDF
    with ``torch.erf`` and the Giles inverse erf, uniforms ``u`` of ``shape``, from
    the key's generator when not given). The draw is clipped into the box in the
    original coordinates too, so that rounding never puts it 1 ulp outside."""
    mean = torch.as_tensor(mean)
    if not mean.dtype.is_floating_point:
        mean = mean.to(torch.float32)
    f = dict(dtype=mean.dtype, device=mean.device)
    scale = torch.as_tensor(scale, **f)
    lo = None if lower is None else torch.as_tensor(lower, **f)
    hi = None if upper is None else torch.as_tensor(upper, **f)
    a, b = _standardize_bounds(mean, scale, lo, hi)
    if shape is None:
        shape = torch.broadcast_shapes(mean.shape, scale.shape, a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    ea = torch.erf(a / _SQRT2)
    eb = torch.erf(b / _SQRT2)
    if u is None:
        u = torch.rand(tuple(shape), generator=key.generator, **f)
    t = ea + u * (eb - ea)
    z = _SQRT2 * fast_erfinv(torch.clamp(t, -1.0 + 1e-7, 1.0 - 1e-7))
    z = torch.clamp(z, a, b)
    out = mean + scale * z
    if lo is not None:
        out = torch.maximum(out, lo)
    if hi is not None:
        out = torch.minimum(out, hi)
    return out


def truncated_normal_log_pdf(x, mean, scale, lower=None, upper=None) -> torch.Tensor:
    """Truncated-normal log-density on [lower, upper], elementwise broadcast; -inf
    outside the box (``None`` is an open side)."""
    x = torch.as_tensor(x)
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    f = dict(dtype=x.dtype, device=x.device)
    mean = torch.as_tensor(mean, **f)
    scale = torch.as_tensor(scale, **f)
    lo = None if lower is None else torch.as_tensor(lower, **f)
    hi = None if upper is None else torch.as_tensor(upper, **f)
    a, b = _standardize_bounds(mean, scale, lo, hi)
    a, b = torch.as_tensor(a, **f), torch.as_tensor(b, **f)
    z = (x - mean) / scale
    log_phi = -0.5 * (z * z + _LOG_2PI) - torch.log(scale)
    inside = (z >= a) & (z <= b)
    return torch.where(inside, log_phi - _log_ndtr_diff(a, b), -torch.inf)


def _log_ndtr_diff(a, b):
    """log(Phi(b) - Phi(a)) for a < b, stable in both tails: with both bounds in
    the upper tail it takes the survival form Phi(-a) - Phi(-b)."""
    use_flip = (a + b) > 0
    lo = torch.where(use_flip, -b, a)
    hi = torch.where(use_flip, -a, b)
    log_hi = torch.special.log_ndtr(hi)
    log_lo = torch.special.log_ndtr(lo)
    return log_hi + torch.log1p(-torch.exp(log_lo - log_hi))


def gibbs_canonical_truncated_normal(key: Key, b, Q, x, lower=None, upper=None, schedule: str = "lex"):
    """One coordinate-wise Gibbs sweep of x ~ N(Q^-1 b, Q^-1) truncated to
    lower < x < upper; x is (p,), (p, n) or (..., p, n), each column a chain,
    and b broadcasts against it.

    Only ``schedule="red_black"`` on a Banded or Diagonal Q is ported: the
    chromatic sweep, bw + 1 vectorised colour updates. The lexicographic sweep
    and permuted precisions raise."""
    Qs = st.as_structured(Q)
    if schedule == "red_black" and isinstance(Qs, (st.Banded, st.Diagonal)):
        return _gibbs_truncated_red_black(key, b, Qs, x, lower, upper)
    raise NotImplementedError(
        f"the {schedule!r} truncated Gibbs schedule on a {type(Qs).__name__} precision is not ported yet "
        f"({_SPARSE_ITEM})"
    )


def _gibbs_truncated_red_black(key: Key, b, Qs, x, lower, upper) -> torch.Tensor:
    """Chromatic (red-black) truncated Gibbs sweep for a banded or diagonal Q.

    Colour class {i : i mod (bw + 1) == c} is an independent set of the
    precision graph, so given the other classes its conditionals factorise and
    the class is one vectorised truncated draw; the classes update in order,
    each reading the ones before it."""
    p = st.dim(Qs)
    x = torch.as_tensor(x)
    shape_in = x.shape
    xf = x if x.dim() >= 2 else x.reshape(p, 1)
    b = torch.as_tensor(b)
    bc = b if b.dim() >= 2 else b.reshape(p, 1)
    lo = _bound_column(lower, p, -math.inf, xf)
    hi = _bound_column(upper, p, math.inf, xf)
    q_diag = st.diag(Qs)[..., None]
    v = 1.0 / q_diag
    s = torch.sqrt(v)
    n_colors = 1 if isinstance(Qs, st.Diagonal) else Qs.bw + 1
    colors = (torch.arange(p, device=xf.device) % n_colors)[:, None]
    for c in range(n_colors):
        cond_mean = v * (bc - st.matvec(Qs, xf) + q_diag * xf)
        draw = truncated_normal_rv(key, cond_mean, s, lo, hi, shape=cond_mean.shape)
        xf = torch.where(colors == c, draw, xf)
    return xf.reshape(shape_in)


def sample_truncated_normal_rejection(key: Key, mu, Q=None, L=None, lower=None, upper=None, n: int = 1,
                                      max_iter: int = 1000, batch_shape=()) -> torch.Tensor:
    """Masked rejection sampling of a box-truncated MVN: every round redraws the
    columns not yet inside the box, until all are or ``max_iter`` rounds have
    run (draws as :func:`sample_normal`). The stopping test reads one flag back
    from the device per round: this runs at prior initialisation, never in the
    sweep loop."""
    chol = _as_chol(Q, L)
    mu = torch.as_tensor(mu)
    p = st.dim(chol)
    like = mu if mu.dtype.is_floating_point else mu.to(torch.float32)
    lo = _bound_column(lower, p, -math.inf, like)
    hi = _bound_column(upper, p, math.inf, like)

    def in_box(samples):
        return torch.all((samples >= lo) & (samples <= hi), dim=-2)

    samples = sample_normal(key, mu, L=chol, n=n, batch_shape=batch_shape)
    accepted = in_box(samples)
    for _ in range(max_iter):
        if bool(torch.all(accepted)):
            break
        fresh = sample_normal(key, mu, L=chol, n=n, batch_shape=batch_shape)
        samples = torch.where(accepted[..., None, :], samples, fresh)
        accepted = in_box(samples)
    return samples


def sample_truncated_normal(key: Key, mu, Q=None, L=None, lower=None, upper=None, n: int = 1,
                            method: str = "Gibbs", n_sweeps: int = 10, init_max_iter: int = 100,
                            schedule: str = "auto", batch_shape=()) -> torch.Tensor:
    """A box-truncated MVN draw, (..., p, n).

    ``method="Gibbs"``: each column starts from an exact rejection draw (bounded
    at ``init_max_iter`` rounds; a column never accepted starts from mu clipped
    into the box) and runs ``n_sweeps`` Gibbs sweeps, each column its own chain.
    ``schedule="auto"`` takes the red-black sweep for a banded or diagonal Q.
    ``method="Rejection"``: masked rejection sampling alone."""
    if method == "Rejection":
        return sample_truncated_normal_rejection(key, mu, Q=Q, L=L, lower=lower, upper=upper, n=n,
                                                 batch_shape=batch_shape)
    if method != "Gibbs":
        raise TypeError("method should be either Gibbs or Rejection")
    if Q is None:
        raise ValueError("Gibbs truncated sampling requires the precision Q")
    Qs = st.as_structured(Q)
    mu = torch.as_tensor(mu)
    p = st.dim(Qs)
    mu_col = (mu if mu.dim() >= 2 else mu.reshape(p, -1))[..., :1]
    b = st.matvec(Qs, mu_col)
    lo = _bound_column(lower, p, -math.inf, mu_col)
    hi = _bound_column(upper, p, math.inf, mu_col)
    x0_clip = torch.clamp(mu_col, lo, hi)
    x0_clip = torch.where(torch.isfinite(x0_clip), x0_clip, torch.zeros_like(x0_clip))
    init = sample_truncated_normal_rejection(key, mu_col, Q=Qs, L=L, lower=lower, upper=upper, n=n,
                                             max_iter=init_max_iter, batch_shape=batch_shape)
    accepted = torch.all((init >= lo) & (init <= hi), dim=-2, keepdim=True)
    x = torch.where(accepted, init, x0_clip)
    if schedule == "auto":
        schedule = "red_black" if isinstance(Qs, (st.Banded, st.Diagonal)) else "lex"
    for _ in range(n_sweeps):
        x = gibbs_canonical_truncated_normal(key, b, Qs, x, lower=lower, upper=upper, schedule=schedule)
    return x
