"""Structured symmetric matrices for GMRF linear algebra (port of
``openmcmc_tpu/linalg/structured.py``).

- :class:`Dense`    -- a full (p, p) matrix.
- :class:`Diagonal` -- a diagonal matrix held as its (p,) diagonal.
- :class:`Banded`   -- a symmetric banded matrix with lower bandwidth ``bw``,
  stored as (bw + 1, p) lower bands: ``bands[j, i] = A[i + j, i]``.

Batching: the JAX package vmaps over chains; here a chain-batched matrix carries
its batch as leading axes of its tensor -- (..., p, p), (..., p) or
(..., bw + 1, p) -- and vectors are (..., p, n). Every function broadcasts the
batch axes of its operands, so per-chain matrices meet constant data without
copies. A 1-D vector (p,) is unbatched.

Banded recurrences (Cholesky, solves) run as Python loops over rows, vectorised
over the batch: the JAX package's associative scans are a TPU device-program
concern, and the hot tridiagonal draw of the generic driver goes to kernel K3
(:mod:`openmcmc_tpu_torch.linalg.tridiag`) instead. ``Permuted``, ``BlockBand``
and ``from_sparse`` are not ported yet (ROADMAP.md queue 1: sparse and permuted
priors);
``linalg/smallmat.py`` is a TPU workaround and is not ported. Matrix products run
at full fp32: the package sets ``torch.set_float32_matmul_precision("highest")``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Dense:
    """Dense symmetric matrix, shape (..., p, p)."""

    mat: torch.Tensor

    @property
    def shape(self):
        return tuple(self.mat.shape[-2:])


@dataclasses.dataclass(frozen=True)
class Diagonal:
    """Diagonal matrix held as its diagonal, shape (..., p)."""

    diag_: torch.Tensor

    @property
    def shape(self):
        p = self.diag_.shape[-1]
        return (p, p)


@dataclasses.dataclass(frozen=True)
class Banded:
    """Symmetric banded matrix with lower bandwidth bw, stored as (..., bw + 1, p) lower bands."""

    bands: torch.Tensor

    @property
    def bw(self) -> int:
        return self.bands.shape[-2] - 1

    @property
    def shape(self):
        p = self.bands.shape[-1]
        return (p, p)


Structured = Union[Dense, Diagonal, Banded]

#: every structured matrix type, for isinstance checks across the package
STRUCTURED_TYPES = (Dense, Diagonal, Banded)


def to(a: Structured, device=None, dtype=None) -> Structured:
    """The same structured matrix with its tensor on ``device`` / in ``dtype``."""
    if isinstance(a, Dense):
        return Dense(torch.as_tensor(a.mat, device=device, dtype=dtype))
    if isinstance(a, Diagonal):
        return Diagonal(torch.as_tensor(a.diag_, device=device, dtype=dtype))
    return Banded(torch.as_tensor(a.bands, device=device, dtype=dtype))


def as_structured(value) -> Structured:
    """A tensor with square trailing axes becomes Dense, a 1-D tensor Diagonal;
    structured values pass."""
    if isinstance(value, STRUCTURED_TYPES):
        return value
    t = torch.as_tensor(value)
    if t.dim() >= 2 and t.shape[-1] == t.shape[-2]:
        return Dense(t)
    if t.dim() == 1:
        return Diagonal(t)
    raise TypeError(f"Cannot interpret a tensor of shape {tuple(t.shape)} as a structured matrix")


def dim(a: Structured) -> int:
    """Matrix dimension p."""
    if isinstance(a, Dense):
        return a.mat.shape[-1]
    if isinstance(a, Diagonal):
        return a.diag_.shape[-1]
    return a.bands.shape[-1]


def batch_shape(a: Structured) -> torch.Size:
    """The leading batch axes of a structured matrix."""
    if isinstance(a, Dense):
        return a.mat.shape[:-2]
    if isinstance(a, Diagonal):
        return a.diag_.shape[:-1]
    return a.bands.shape[:-2]


def to_dense(a: Structured) -> torch.Tensor:
    """Materialize as a (..., p, p) tensor."""
    if isinstance(a, Dense):
        return a.mat
    if isinstance(a, Diagonal):
        return torch.diag_embed(a.diag_)
    p = dim(a)
    out = torch.diag_embed(a.bands[..., 0, :])
    for j in range(1, a.bw + 1):
        band = a.bands[..., j, : p - j]
        out = out + torch.diag_embed(band, offset=-j) + torch.diag_embed(band, offset=j)
    return out


def diag(a: Structured) -> torch.Tensor:
    """Main diagonal, shape (..., p)."""
    if isinstance(a, Dense):
        return torch.diagonal(a.mat, dim1=-2, dim2=-1)
    if isinstance(a, Diagonal):
        return a.diag_
    return a.bands[..., 0, :]


def scale(c, a: Structured) -> Structured:
    """c * A for a scalar c: a Python number, a one-element tensor, or a
    chain-batched state scalar (..., 1, 1), which batches the result. A Python
    number stays one, so that it never becomes a CPU tensor beside a CUDA one."""
    if torch.is_tensor(c):
        lead = c.shape[:-2] if c.dim() > 2 else ()
        c_mat, c_vec = c.reshape(lead + (1, 1)), c.reshape(lead + (1,))
    else:
        c_mat = c_vec = float(c)
    if isinstance(a, Dense):
        return Dense(c_mat * a.mat)
    if isinstance(a, Diagonal):
        return Diagonal(c_vec * a.diag_)
    return Banded(c_mat * a.bands)


def _banded_from_diagonal(d: Diagonal, bw: int) -> Banded:
    return Banded(F.pad(d.diag_.unsqueeze(-2), (0, 0, 0, bw)))


def add(a: Structured, b: Structured) -> Structured:
    """A + B, promoting to the least-dense structure able to represent the sum;
    batch axes broadcast."""
    if isinstance(a, Dense) or isinstance(b, Dense):
        return Dense(to_dense(a) + to_dense(b))
    if isinstance(a, Diagonal) and isinstance(b, Diagonal):
        return Diagonal(a.diag_ + b.diag_)
    # at least one Banded, none Dense
    if isinstance(a, Diagonal):
        a = _banded_from_diagonal(a, b.bw)
    if isinstance(b, Diagonal):
        b = _banded_from_diagonal(b, a.bw)
    bw = max(a.bw, b.bw)
    pa = F.pad(a.bands, (0, 0, 0, bw - a.bw))
    pb = F.pad(b.bands, (0, 0, 0, bw - b.bw))
    return Banded(pa + pb)


def matvec(a: Structured, x: torch.Tensor) -> torch.Tensor:
    """A @ x for x of shape (p,) or (..., p, n)."""
    if isinstance(a, Dense):
        return torch.matmul(a.mat, x)
    vec = x.dim() == 1
    if vec:
        x = x[:, None]
    if isinstance(a, Diagonal):
        y = a.diag_[..., :, None] * x
    else:
        # symmetric banded: y[i] = b0[i] x[i] + sum_j bands[j, i] x[i + j] + bands[j, i - j] x[i - j]
        p = x.shape[-2]
        y = a.bands[..., 0, :, None] * x
        for j in range(1, a.bw + 1):
            bj = a.bands[..., j, : p - j, None]
            y = y + F.pad(bj * x[..., j:, :], (0, 0, 0, j))
            y = y + F.pad(bj * x[..., : p - j, :], (0, 0, j, 0))
    return y[..., 0] if vec else y


# ---------------------------------------------------------------------------
# Cholesky factorizations
# ---------------------------------------------------------------------------


def cholesky(a: Structured) -> Structured:
    """Lower Cholesky factor, in the same structure as the input.

    Dense runs batched ``torch.linalg.cholesky_ex`` (no host check of its info:
    a matrix that is not positive definite gives a partial factor, as the JAX
    package gives NaN, instead of a device-to-host read per call). Banded runs
    the column recurrence row by row; pivots are clamped at 1e-30 as in the JAX
    package: an intrinsic prior such as the unridged RW1 precision has a
    numerically zero last pivot, and the clamp keeps the factor and the logdet
    pseudo-constant finite."""
    if isinstance(a, Dense):
        return Dense(torch.linalg.cholesky_ex(a.mat).L)
    if isinstance(a, Diagonal):
        return Diagonal(torch.sqrt(a.diag_))
    if a.bw == 0:
        return Banded(torch.sqrt(a.bands))
    if a.bw == 1:
        return Banded(_tridiag_cholesky(a.bands))
    return Banded(_banded_cholesky(a.bands))


def _tridiag_cholesky(bands: torch.Tensor) -> torch.Tensor:
    """Pivot recurrence d_i = a_i - c_{i-1}^2 / d_{i-1}, then L = (sqrt d, c / sqrt d)."""
    main, off = bands[..., 0, :], bands[..., 1, :]
    p = main.shape[-1]
    pivots = [main[..., 0]]
    for i in range(1, p):
        pivots.append(main[..., i] - off[..., i - 1] * off[..., i - 1] / pivots[-1])
    l_diag = torch.sqrt(torch.clamp(torch.stack(pivots, dim=-1), min=1e-30))
    l_off = F.pad(off[..., : p - 1] / l_diag[..., : p - 1], (0, 1))
    return torch.stack([l_diag, l_off], dim=-2)


def _banded_cholesky(bands: torch.Tensor) -> torch.Tensor:
    """Banded Cholesky: lower band storage in, lower band storage of L out.

    Column recurrence over columns i (JAX ``_banded_cholesky``):
        L[i, i]     = sqrt(A[i, i] - sum_m L[i, i-1-m]^2)
        L[i+j, i]   = (A[i+j, i] - sum_m L[i+j, i-1-m] * L[i, i-1-m]) / L[i, i]
    The carry ``w`` holds the band columns of the last bw columns of L."""
    bw = bands.shape[-2] - 1
    p = bands.shape[-1]
    m_idx = torch.arange(bw, device=bands.device)
    j_idx = torch.arange(1, bw + 1, device=bands.device)
    lik_col = 1 + m_idx  # L[i, i-1-m] sits at band row 1 + m of column i-1-m
    cross_col = j_idx[:, None] + 1 + m_idx[None, :]  # L[i+j, i-1-m]: band row j + 1 + m
    w = bands.new_zeros(bands.shape[:-2] + (bw, bw + 1))  # w[..., m, :] = band column i-1-m
    cols = []
    for i in range(p):
        wp = F.pad(w, (0, bw))  # room to index band rows up to 2 bw
        lik = wp[..., m_idx, lik_col]  # (..., bw)
        a_col = bands[..., :, i]
        d = torch.sqrt(torch.clamp(a_col[..., 0] - torch.sum(lik * lik, dim=-1), min=1e-30))
        cross = wp[..., m_idx[None, :].expand(bw, bw), cross_col]  # (..., bw, bw)
        sj = torch.matmul(cross, lik[..., None])[..., 0]
        off = (a_col[..., 1:] - sj) / d[..., None]
        off = torch.where(i + j_idx < p, off, torch.zeros_like(off))
        col = torch.cat([d[..., None], off], dim=-1)
        cols.append(col)
        w = torch.cat([col[..., None, :], w[..., :-1, :]], dim=-2)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# Triangular solves against a lower Cholesky factor
# ---------------------------------------------------------------------------


def _as_columns(b: torch.Tensor):
    vec = b.dim() == 1
    return (b[:, None] if vec else b), vec


def solve_lower(chol: Structured, b: torch.Tensor) -> torch.Tensor:
    """Solve L w = b for lower-triangular structured L; b is (p,) or (..., p, n)."""
    rhs, vec = _as_columns(b)
    if isinstance(chol, Dense):
        out = torch.linalg.solve_triangular(chol.mat, rhs, upper=False)
    elif isinstance(chol, Diagonal):
        out = rhs / chol.diag_[..., :, None]
    else:
        out = _banded_solve_lower(chol.bands, rhs)
    return out[..., 0] if vec else out


def solve_upper_t(chol: Structured, b: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = b for lower-triangular structured L; b is (p,) or (..., p, n)."""
    rhs, vec = _as_columns(b)
    if isinstance(chol, Dense):
        out = torch.linalg.solve_triangular(chol.mat.mT, rhs, upper=True)
    elif isinstance(chol, Diagonal):
        out = rhs / chol.diag_[..., :, None]
    else:
        out = _banded_solve_upper_t(chol.bands, rhs)
    return out[..., 0] if vec else out


def _band_rows(bands: torch.Tensor) -> torch.Tensor:
    """Row storage R[j, i] = L[i, i-j] from column storage C[j, i] = L[i+j, i]."""
    p = bands.shape[-1]
    rows = [bands[..., 0, :]]
    for j in range(1, bands.shape[-2]):
        rows.append(F.pad(bands[..., j, : p - j], (j, 0)))
    return torch.stack(rows, dim=-2)


def _substitute(diag_and_links: torch.Tensor, rhs: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x_i = (rhs_i - sum_{j=1..bw} links[j, i] x_{i -+ j}) / links[0, i], sequentially.

    ``diag_and_links`` is (..., bw + 1, p); rhs is (..., p, n). Forward order takes
    x_{i-j} (row storage), reverse order x_{i+j} (column storage)."""
    bw = diag_and_links.shape[-2] - 1
    p, n = rhs.shape[-2], rhs.shape[-1]
    batch = torch.broadcast_shapes(diag_and_links.shape[:-2], rhs.shape[:-2])
    carry = rhs.new_zeros(batch + (bw, n))  # carry[..., m, :] = x_{i -+ (1 + m)}
    xs = [None] * p
    for i in reversed(range(p)) if reverse else range(p):
        links = diag_and_links[..., :, i]
        acc = rhs[..., i, :] - torch.sum(links[..., 1:, None] * carry, dim=-2)
        x_i = acc / links[..., 0:1]
        xs[i] = x_i
        carry = torch.cat([x_i[..., None, :], carry[..., :-1, :]], dim=-2)
    return torch.stack(xs, dim=-2)


def _banded_solve_lower(bands: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution: x[i] = (b[i] - sum_j L[i, i-j] x[i-j]) / L[i, i]."""
    if bands.shape[-2] == 1:
        return b / bands[..., 0, :, None]
    return _substitute(_band_rows(bands), b, reverse=False)


def _banded_solve_upper_t(bands: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Back substitution on L^T: x[i] = (b[i] - sum_j L[i+j, i] x[i+j]) / L[i, i]."""
    if bands.shape[-2] == 1:
        return b / bands[..., 0, :, None]
    return _substitute(bands, b, reverse=True)


def chol_log_det(chol: Structured) -> torch.Tensor:
    """log det(Q) = 2 * sum(log diag(L)) for the lower Cholesky factor L of Q."""
    return 2.0 * torch.sum(torch.log(diag(chol)), dim=-1)


def host_log_det(a: Structured) -> float:
    """log det(A) by :func:`chol_log_det` of :func:`cholesky`, on a float32 host
    copy: the once-per-run value for constant data, whose tridiagonal pivot
    recurrence would otherwise be p tiny device launches."""
    return float(chol_log_det(cholesky(to(a, "cpu", torch.float32))))


def chol_matvec_t(chol: Structured, x: torch.Tensor) -> torch.Tensor:
    """L^T @ x for lower-triangular structured L; x is (p,) or (..., p, n)."""
    rhs, vec = _as_columns(x)
    if isinstance(chol, Dense):
        y = torch.matmul(chol.mat.mT, rhs)
    elif isinstance(chol, Diagonal):
        y = chol.diag_[..., :, None] * rhs
    else:
        # (L^T)[i, i+j] = C[j, i]
        bands = chol.bands
        y = bands[..., 0, :, None] * rhs
        for j in range(1, bands.shape[-2]):
            y = y + bands[..., j, :, None] * F.pad(rhs[..., j:, :], (0, 0, 0, j))
    return y[..., 0] if vec else y


def cho_solve(chol: Structured, b: torch.Tensor) -> torch.Tensor:
    """Solve Q x = b given the lower Cholesky factor of Q."""
    return solve_upper_t(chol, solve_lower(chol, b))


def solve(a: Structured, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD structured A."""
    return cho_solve(cholesky(a), b)
