"""Gaussian-kernel basis hooks for reversible-jump regression (port of
``openmcmc_tpu/basis.py``).

The knot-basis regression regresses on a variable-size basis

    B[:, j] = normpdf(X; theta_j, omega_j)          (active columns j < count)

rebuilt inside the samplers' state-update hooks. The hooks are bound methods of
one :class:`GaussianKernelBasis`, which the fused-engine dispatcher recognises
(an opaque callable would not tell it what the basis is), so that
``MCMC.run(engine="auto")`` can run the fused reversible-jump kernel.

Padded convention (:mod:`openmcmc_tpu_torch.padding`): theta and omega are
(..., 1, n_max) with zero padding, B is (..., n_data, n_max) with zero padded
columns; the leading axes are the chains.
"""

from __future__ import annotations

import math

import torch

from openmcmc_tpu_torch import padding

_TWO_PI = 2.0 * math.pi


def normpdf(x, loc, scale):
    """The normal density in the JAX package's operation order
    (``jax.scipy.stats.norm.pdf``): exp((log(2 pi s^2) + (x - loc)^2 / s^2) / -2)."""
    s2 = scale * scale
    log_normalizer = torch.log(_TWO_PI * s2)
    d = x - loc
    return torch.exp((log_normalizer + (d * d) / s2) / -2.0)


class GaussianKernelBasis:
    """Hook bundle maintaining ``B[:, j] = normpdf(X; theta_j, omega_j)``.

    Args:
        x: state name of the (n_data, 1) evaluation points (constant data).
        matrix: state name of the padded (n_data, n_max) basis matrix.
        theta: state name of the padded (1, n_max) kernel locations.
        omega: state name of the padded (1, n_max) kernel scales.
        count: state name of the integer active count.

    Pass ``basis.birth`` / ``basis.death`` to :class:`ReversibleJump`'s
    ``state_birth_function`` / ``state_death_function`` and ``basis.move`` /
    ``basis.move_vec`` to the theta/omega :class:`RandomWalkLoop`'s
    ``state_update_function`` / ``vector_state_update_function``.
    """

    def __init__(self, x="X", matrix="B", theta="theta", omega="omega", count="n_basis"):
        self.x = x
        self.matrix = matrix
        self.theta = theta
        self.omega = omega
        self.count = count

    def make(self, X, theta, omega, count):
        """Full padded basis (..., n_data, n_max); padded columns are exactly zero.
        Floating inputs keep their type (float32 in the driver), others become float32."""
        X, theta, omega = (torch.as_tensor(v) for v in (X, theta, omega))
        if not theta.dtype.is_floating_point:
            theta = theta.to(torch.float32)
        X, omega = X.to(theta.dtype), omega.to(theta.dtype)
        om = torch.where(omega > 0, omega, torch.ones((), dtype=omega.dtype, device=omega.device))
        B = normpdf(X, theta, om)
        mask = padding.active_mask(torch.as_tensor(count, device=B.device), theta.shape[-1], B.dtype)
        return B * mask[..., None, :]

    # -- ReversibleJump hooks ------------------------------------------------

    def birth(self, key, current_state, prop_state):
        prop_state = dict(prop_state)
        prop_state[self.matrix] = self.make(
            prop_state[self.x], prop_state[self.theta], prop_state[self.omega], prop_state[self.count]
        )
        return prop_state, 0.0, 0.0

    def death(self, key, current_state, prop_state, deletion_index):
        return self.birth(key, current_state, prop_state)

    # -- RandomWalkLoop hooks ------------------------------------------------

    def move(self, key, updates, state, i):
        """Sequential-path hook: a single-column proposal changes only column i."""
        updates = dict(updates)
        th = updates.get(self.theta, state[self.theta])
        om = updates.get(self.omega, state[self.omega])
        th_i, om_i = th[..., :, i:i + 1], om[..., :, i:i + 1]
        om_i = torch.where(om_i > 0, om_i, torch.ones((), dtype=om_i.dtype, device=om_i.device))
        col = normpdf(state[self.x], th_i, om_i)
        count = state[self.count]
        active = (i < count.reshape(count.shape[:-2] + (1, 1))).to(col.dtype)
        B = state[self.matrix]
        at_i = torch.arange(B.shape[-1], device=B.device) == i
        updates[self.matrix] = torch.where(at_i, col * active, B)
        return updates, 0.0, 0.0

    def move_vec(self, key, updates, state):
        """Vectorized-path hook: one full basis rebuild after the per-column accepts."""
        updates = dict(updates)
        th = updates.get(self.theta, state[self.theta])
        om = updates.get(self.omega, state[self.omega])
        updates[self.matrix] = self.make(state[self.x], th, om, state[self.count])
        return updates
