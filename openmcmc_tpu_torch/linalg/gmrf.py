"""GMRF precision builders and Gaussian samplers (port of ``openmcmc_tpu/linalg/gmrf.py``).

Ported so far: :func:`precision_irregular` (the RW1 prior of the flagship
smoother), :func:`sample_normal`, :func:`sample_normal_canonical` and
:func:`mvn_log_pdf`, chain-batched through leading axes (see
:mod:`openmcmc_tpu_torch.linalg.structured`). The truncated samplers and
``Permuted`` precisions come with the Thomas kernel (ROADMAP.md queue 1: Thomas
smoother); ``precision_temporal`` with the generic driver's follow-up (queue 1
item 2, deferred).

Randomness: where the JAX package takes a key, the port takes a :class:`Key`,
the run's ``torch.Generator`` plus the Philox key and call counter of kernel
draws.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.linalg import tridiag

_LOG_2PI = math.log(2.0 * math.pi)


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
