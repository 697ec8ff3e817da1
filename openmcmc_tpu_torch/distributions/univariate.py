"""Univariate distributions (port of ``openmcmc_tpu/distributions/univariate.py``).

Ported so far: :class:`Gamma`'s ``log_p`` and ``sample`` and
:class:`Categorical`'s, with leading chain axes on the entries kept in the
result. Poisson and Uniform come with the reversible-jump slice (ROADMAP.md
queue 1: reversible jump).
"""

from __future__ import annotations

import math
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


@dataclass(frozen=True, init=False)
class Categorical(Distribution):
    """Categorical (single-trial multinomial) over category indices.

    state[response] is an integer array (..., p, n) of category indices and the
    probability parameter is (..., p, n_cat). log_p is the log-probability of the
    observed index sequence, sum_ij log prob[i, x[i, j]], taken by a gather
    (the JAX package contracts with a one-hot mask, a TPU workaround).
    ``aggregated=True`` reproduces the reference's multinomial pmf on the counts
    per dimension, log-multinomial coefficient included, for n > 1 replicates
    without ``by_observation``."""

    prob: Parameter
    aggregated: bool

    def __init__(self, response: str, prob, aggregated: bool = False):
        object.__setattr__(self, "response", response)
        object.__setattr__(self, "prob", _as_parameter(prob, "prob"))
        object.__setattr__(self, "aggregated", bool(aggregated))

    @property
    def _dist_params(self) -> List[str]:
        return self.prob.get_param_list()

    def log_p(self, state: dict, by_observation: bool = False):
        x = state[self.response].to(torch.int64)  # (..., p, n)
        logprob = torch.log(self.prob.predictor(state))  # (..., p, n_cat)
        n, n_cat = x.shape[-1], logprob.shape[-1]
        batch = torch.broadcast_shapes(x.shape[:-2], logprob.shape[:-2])
        if self.aggregated and not by_observation and n > 1:
            counts = torch.sum(x[..., None] == torch.arange(n_cat, device=x.device), dim=-2).to(logprob.dtype)
            coeff = math.lgamma(n + 1.0) - torch.sum(torch.lgamma(counts + 1.0), dim=-1)
            return torch.sum(coeff + torch.sum(counts * logprob, dim=-1), dim=-1)
        p = x.shape[-2]
        lp = torch.gather(logprob.expand(batch + (p, n_cat)), -1, x.expand(batch + (p, n)))  # (..., p, n)
        log_p = torch.sum(lp, dim=-2)
        return log_p if by_observation else torch.sum(log_p, dim=-1)

    def sample(self, key, state: dict, n: int = 1, batch_shape=()):
        """Category indices (..., p, n) drawn by inverse CDF from one uniform of
        the key's generator each (the JAX package draws by
        ``jax.random.categorical``). The indices are int32, the driver's type for
        an allocation; the JAX package returns them as floats."""
        prob = self.prob.predictor(state)
        batch = torch.broadcast_shapes(tuple(batch_shape), prob.shape[:-2])
        p, n_cat = prob.shape[-2:]
        u = torch.rand(batch + (p, n), generator=key.generator, dtype=prob.dtype, device=prob.device)
        return categorical_icdf(prob.expand(batch + (p, n_cat))[..., None, :], u)


def categorical_icdf(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF category index of unnormalized ``weights`` (..., n_cat) for
    uniforms ``u`` (...): #{k < n_cat - 1 : u * sum(weights) >= cum_k}, int32."""
    cum = torch.cumsum(weights, dim=-1)
    target = (u * cum[..., -1])[..., None]
    return torch.sum(target >= cum[..., :-1], dim=-1).to(torch.int32)
