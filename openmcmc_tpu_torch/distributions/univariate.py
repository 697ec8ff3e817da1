"""Univariate distributions (port of ``openmcmc_tpu/distributions/univariate.py``).

Ported so far: :class:`Gamma`'s ``log_p`` and ``sample``, with leading chain
axes on the entries kept in the result. Poisson, Uniform and Categorical come
with the mixture and reversible-jump slices (ROADMAP.md queue 1: mixture; reversible jump).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from openmcmc_tpu_torch.distributions.base import Distribution
from openmcmc_tpu_torch.parameters import Identity, Parameter


def _as_parameter(value, what: str) -> Parameter:
    if isinstance(value, str):
        value = Identity(value)
    if not isinstance(value, Identity):
        raise TypeError(f"{what} expected to be Identity in the port so far")
    return value


@dataclass(frozen=True, init=False)
class Gamma(Distribution):
    """Gamma in shape/rate convention: f(x) proportional to x^(a-1) exp(-b x)."""

    shape: Parameter
    rate: Parameter

    #: log_p is a sum of per-replicate-column terms, each reading only that column
    #: of the response (RandomWalkLoop's vectorized path reads this)
    column_factorized = True

    def __init__(self, response: str, shape, rate, n_active=None):
        if n_active is not None:
            raise NotImplementedError(
                "Gamma(n_active=...) is not ported yet (ROADMAP.md queue 1: reversible jump)"
            )
        object.__setattr__(self, "response", response)
        object.__setattr__(self, "shape", _as_parameter(shape, "shape"))
        object.__setattr__(self, "rate", _as_parameter(rate, "rate"))

    @property
    def _dist_params(self) -> List[str]:
        return self.shape.get_param_list() + self.rate.get_param_list()

    def log_p(self, state: dict, by_observation: bool = False):
        x = state[self.response]
        a = self.shape.predictor(state)
        b = self.rate.predictor(state)
        log_p = torch.sum((a - 1.0) * torch.log(x) - b * x + a * torch.log(b) - torch.lgamma(a), dim=-2)
        return log_p if by_observation else torch.sum(log_p, dim=-1)

    def sample(self, key, state: dict, n: int = 1, batch_shape=()):
        """Gamma(a, b) draws of shape (..., p, n) from the first column of the
        shape and rate, the batch broadcast with ``batch_shape``. The variates
        come from ``torch._standard_gamma`` on the key's generator (the JAX
        package uses ``jax.random.gamma``)."""
        a = self.shape.predictor(state)[..., :1]
        b = self.rate.predictor(state)[..., :1]
        p = max(a.shape[-2], b.shape[-2])
        batch = torch.broadcast_shapes(tuple(batch_shape), a.shape[:-2], b.shape[:-2])
        conc = a.expand(batch + (p, n)).contiguous()
        return torch._standard_gamma(conc, generator=key.generator) / b
