"""Carry state across from the JAX package.

:func:`state_from_reference` turns an ``openmcmc_tpu`` state dict into the
port's: the same names, the same shapes, tensors on the chosen device. It
imports neither JAX nor the JAX package -- leaves are read through
``np.asarray``, and structured matrices are recognised by their attributes.
"""

from __future__ import annotations

import numpy as np

from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.mcmc import _coerce_state

_UNPORTED = ("inner", "perm", "blocks")  # Permuted, BlockBand


def _leaf(name, value):
    arr = np.array(value)  # a writable copy: JAX arrays read back read-only
    if arr.dtype == object:
        raise TypeError(f"state[{name!r}]: {type(value).__name__} is not an array or a known structured matrix")
    return arr


def state_from_reference(state: dict, device="cuda") -> dict:
    """A JAX-package state dict as the port's coerced state on ``device`` (the
    card unless the caller asks for the CPU).

    Arrays and scalars are coerced as ``MCMC`` coerces them; ``Banded``,
    ``Diagonal`` and ``Dense`` (attributes ``bands``, ``diag_``, ``mat``) become
    the port's types. ``Permuted`` and ``BlockBand`` raise: they are not ported,
    and densifying them silently would change the engine a model dispatches to."""
    out = {}
    for name, value in state.items():
        kind = type(value).__name__
        if any(hasattr(value, a) for a in _UNPORTED):
            raise NotImplementedError(
                f"state[{name!r}]: {kind} is not ported yet (ROADMAP.md queue 1: sparse and permuted priors)"
            )
        if hasattr(value, "bands"):
            out[name] = st.Banded(_leaf(name, value.bands))
        elif hasattr(value, "diag_"):
            out[name] = st.Diagonal(_leaf(name, value.diag_))
        elif hasattr(value, "mat"):
            out[name] = st.Dense(_leaf(name, value.mat))
        else:
            out[name] = _leaf(name, value)
    return _coerce_state(out, device)
