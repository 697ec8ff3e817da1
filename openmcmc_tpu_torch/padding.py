"""Padded variable-dimension state for reversible jump (port of ``openmcmc_tpu/padding.py``).

Every variable-dimension parameter is padded to a maximum size, with an integer
active count in the state:

- active entries occupy indices 0..count-1 along the variable axis;
- padding entries are zero (padded basis columns times padded coefficients add
  nothing to a predictor);
- birth writes at index ``count``; death deletes order-preservingly (np.delete
  semantics) and zeroes the tail.

Arrays are state entries (..., p, n) with optional leading chain axes; ``axis``
0 or 1 names the state axis (p or n), a negative axis counts from the end.
Counts and indices are ints or tensors with one value per chain: (chains,),
(chains, 1, 1) or a single value. ``take_column`` gathers; the JAX package
contracts with one-hot masks there, a TPU workaround for per-chain gathers.
"""

from __future__ import annotations

import torch


def _dim(arr: torch.Tensor, axis: int) -> int:
    return axis - 2 if axis >= 0 else axis


def _per_chain(value, arr: torch.Tensor) -> torch.Tensor:
    """A count or index as a tensor broadcasting against ``arr`` (..., p, n):
    (..., 1, 1), or (1, 1) for a single value."""
    v = torch.as_tensor(value, device=arr.device).reshape(-1)
    if v.numel() == 1:
        return v.reshape((1,) * arr.dim())
    return v.reshape(tuple(arr.shape[:-2]) + (1, 1))


def _position(arr: torch.Tensor, dim: int) -> torch.Tensor:
    """(1, .., size, .., 1) positions along ``dim`` of ``arr``."""
    shape = [1] * arr.dim()
    shape[dim] = arr.shape[dim]
    return torch.arange(arr.shape[dim], device=arr.device).reshape(shape)


def active_mask(count, size: int, dtype=None) -> torch.Tensor:
    """(..., size) mask: True (or 1 in ``dtype``) at indices < count. A count
    entry (..., 1, 1) gives one row per chain; a single value gives (size,)."""
    c = torch.as_tensor(count)
    if c.dim() >= 2 and tuple(c.shape[-2:]) == (1, 1):
        c = c[..., 0, 0]
    mask = torch.arange(size, device=c.device) < c[..., None]
    return mask if dtype is None else mask.to(dtype)


def mask_along_axis(arr: torch.Tensor, count, axis: int) -> torch.Tensor:
    """Zero the entries at positions >= count along ``axis``."""
    dim = _dim(arr, axis)
    keep = _position(arr, dim) < _per_chain(count, arr)
    return torch.where(keep, arr, torch.zeros((), dtype=arr.dtype, device=arr.device))


def append(arr: torch.Tensor, value: torch.Tensor, count, axis: int) -> torch.Tensor:
    """Write ``value`` (size 1 along ``axis``) at index ``count`` (the birth move)."""
    dim = _dim(arr, axis)
    at = _position(arr, dim) == _per_chain(count, arr)
    return torch.where(at, torch.as_tensor(value, dtype=arr.dtype, device=arr.device), arr)


def delete(arr: torch.Tensor, index, count, axis: int) -> torch.Tensor:
    """Order-preserving delete of ``index`` along ``axis`` (the death move): the
    tail shifts left by one and everything at positions >= count - 1 is zero."""
    dim = _dim(arr, axis)
    shifted = torch.cat([arr.narrow(dim, 1, arr.shape[dim] - 1), torch.zeros_like(arr.narrow(dim, 0, 1))], dim=dim)
    out = torch.where(_position(arr, dim) < _per_chain(index, arr), arr, shifted)
    return mask_along_axis(out, _per_chain(count, arr) - 1, axis)


def take_column(arr: torch.Tensor, index, axis: int) -> torch.Tensor:
    """The slice at ``index`` along ``axis``, the axis kept with size 1 (a gather);
    zero where the index lies outside the axis (a birth's index n_max on a chain
    whose birth is selected away), as the JAX package's one-hot reduction gives."""
    dim = _dim(arr, axis)
    size = arr.shape[dim]
    idx = _per_chain(index, arr).to(torch.int64)
    shape = list(arr.shape)
    shape[dim] = 1
    idx = idx.expand(torch.broadcast_shapes(idx.shape, tuple(shape)))
    out = torch.gather(arr.expand(tuple(idx.shape[:-2]) + tuple(arr.shape[-2:])), dim, idx.clamp(0, size - 1))
    return torch.where((idx >= 0) & (idx < size), out, torch.zeros((), dtype=arr.dtype, device=arr.device))


def insert_column(mat: torch.Tensor, column: torch.Tensor, col_index) -> torch.Tensor:
    """Shift the columns of ``mat`` (..., p, m) right from ``col_index`` and place
    ``column`` (..., p, 1) there."""
    pos = torch.arange(mat.shape[-1], device=mat.device)
    c = _per_chain(col_index, mat)[..., 0, :]  # (..., 1, 1) -> (..., 1)
    shifted = torch.cat([mat[..., :, :1], mat[..., :, :-1]], dim=-1)
    out = torch.where((pos > c)[..., None, :], shifted, mat)
    return torch.where((pos == c)[..., None, :], column, out)


def insert_identity_column(mat: torch.Tensor, col_index, row_index=None) -> torch.Tensor:
    """Shift the columns of ``mat`` right from ``col_index`` and place the unit
    vector e_{row_index} there (``row_index`` defaults to ``col_index``): the
    death move's transition matrix F."""
    if row_index is None:
        row_index = col_index
    rows = torch.arange(mat.shape[-2], device=mat.device)
    r = _per_chain(row_index, mat)[..., 0, :]  # (..., 1)
    unit = (rows == r).to(mat.dtype)[..., :, None]
    return insert_column(mat, unit, col_index)
