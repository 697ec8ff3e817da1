"""Location-scale distributions (port of ``openmcmc_tpu/distributions/location_scale.py``).

Ported so far: :class:`Normal` in precision form with an Identity,
LinearCombination or MixtureParameterVector mean and an Identity, ScaledMatrix
or MixtureParameterMatrix precision (a mixture precision is a per-chain
Diagonal): its density, its draw, box-truncated or not, and its gradient and
negative Hessian (analytic for the response and a linear mean parameter,
autodiff otherwise). A truncated
Normal keeps the reference's unrenormalised density (-inf outside the box) and
draws by rejection-initialised red-black Gibbs; ``n_active`` waits for
reversible jump (ROADMAP.md queue 1: reversible jump). Entries may carry leading
chain axes: state[name] is (p, n) or (..., p, n), and densities keep the batch
axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from openmcmc_tpu_torch.distributions.base import Distribution
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.parameters import (
    Identity,
    LinearCombination,
    MixtureParameterMatrix,
    MixtureParameterVector,
    Parameter,
    ScaledMatrix,
)

_LOG_2PI = math.log(2.0 * math.pi)
_MEAN_TYPES = (Identity, LinearCombination, MixtureParameterVector)
_PRECISION_TYPES = (Identity, ScaledMatrix, MixtureParameterMatrix)


def _coerce(value, allowed, what):
    if isinstance(value, str):
        value = Identity(value)
    if not isinstance(value, allowed):
        names = ", ".join(t.__name__ for t in allowed)
        raise TypeError(f"{what} expected to be one of [{names}] in the port so far")
    return value


@dataclass(frozen=True, init=False)
class LocationScale(Distribution):
    """Mean + precision parameterization."""

    mean: Parameter
    precision: Parameter

    def __init__(self, response: str, mean, precision):
        object.__setattr__(self, "response", response)
        object.__setattr__(self, "mean", _coerce(mean, _MEAN_TYPES, "mean"))
        object.__setattr__(self, "precision", _coerce(precision, _PRECISION_TYPES, "precision"))

    @property
    def _dist_params(self) -> List[str]:
        return self.mean.get_param_list() + self.precision.get_param_list()


@dataclass(frozen=True, init=False)
class Normal(LocationScale):
    """Multivariate normal in precision form."""

    domain_response_lower: Optional[tuple]
    domain_response_upper: Optional[tuple]

    def __init__(self, response, mean, precision, domain_response_lower=None, domain_response_upper=None,
                 n_active=None):
        super().__init__(response, mean, precision)
        if n_active is not None:
            raise NotImplementedError(
                "Normal(n_active=...) is not ported yet (ROADMAP.md queue 1: reversible jump)"
            )

        def conv(v):
            if v is None:
                return None
            return tuple(np.atleast_1d(np.asarray(v, dtype=float)).reshape(-1).tolist())

        object.__setattr__(self, "domain_response_lower", conv(domain_response_lower))
        object.__setattr__(self, "domain_response_upper", conv(domain_response_upper))

    @property
    def truncated(self) -> bool:
        return self.domain_response_lower is not None or self.domain_response_upper is not None

    def _bounds(self, device=None):
        """The box as (p, 1) float32 columns (or a (1, 1) scalar), None for an open side."""
        def col(v):
            return None if v is None else torch.tensor(v, dtype=torch.float32, device=device).reshape(-1, 1)

        return col(self.domain_response_lower), col(self.domain_response_upper)

    def out_of_domain(self, state: dict) -> torch.Tensor:
        """Does the response lie outside the box? One boolean per batch element
        (a 0-d tensor for an unbatched state)."""
        x = state[self.response]
        lo, hi = self._bounds(x.device)
        bad = torch.zeros(x.shape[:-2], dtype=torch.bool, device=x.device)
        if lo is not None:
            bad = bad | torch.any(x < lo, dim=(-2, -1))
        if hi is not None:
            bad = bad | torch.any(x > hi, dim=(-2, -1))
        return bad

    def unscaled_log_det(self, state: dict) -> float:
        """log|P| of a ScaledMatrix precision's matrix: constant data in every
        ported model, so the driver computes it once per run on the host
        (:func:`structured.host_log_det`) and hands it to :meth:`log_p`."""
        return st.host_log_det(st.as_structured(state[self.precision.matrix]))

    def log_p(self, state: dict, by_observation: bool = False, log_det=None):
        """log N(x; mu, Q^-1) with Q = c P for a ScaledMatrix (c = 1 for Identity):
        1/2 (d log c + log|P| - d log 2 pi - c (x - mu)' P (x - mu)), per column,
        summed over columns unless ``by_observation``; the batch axes stay.
        ``log|P|`` comes from the structured Cholesky, as in the JAX package, or
        from ``log_det`` when the caller computed it once (:meth:`unscaled_log_det`).
        A truncated Normal is -inf where the response leaves the box (the
        reference's unrenormalised truncation)."""
        log_p = self._log_p(state, by_observation, log_det)
        if self.truncated:
            bad = self.out_of_domain(state)
            log_p = torch.where(bad[..., None] if by_observation else bad, -torch.inf, log_p)
        return log_p

    def _log_p(self, state: dict, by_observation: bool, log_det):
        x = state[self.response]
        mu = self.mean.predictor(state)
        if not isinstance(self.precision, ScaledMatrix):
            Q = st.as_structured(self.precision.predictor(state))
            return gmrf.mvn_log_pdf(x, mu, Q=Q, by_observation=by_observation)
        scalar = torch.as_tensor(state[self.precision.scalar])
        scalar = scalar.reshape(scalar.shape[:-2] + (1,)) if scalar.dim() > 2 else scalar.reshape(1)
        P = st.as_structured(state[self.precision.matrix])
        if log_det is None:
            log_det = st.chol_log_det(st.cholesky(P))[..., None]
        d = x.shape[-2]
        r = x - mu
        quad = torch.sum(r * st.matvec(P, r), dim=-2)
        log_p = 0.5 * (d * torch.log(scalar) + log_det - d * _LOG_2PI - scalar * quad)
        return log_p if by_observation else torch.sum(log_p, dim=-1)

    def grad_log_p(self, state: dict, param: str, hessian_required: bool = True):
        """Gradient and NEGATIVE Hessian of log_p, chain-batched, in the JAX
        package's three cases:

        - the response, with W the precision and r = x - mean: gradient -W r,
          Hessian W densified, Kronecker'd with I_n over n > 1 replicate columns;
        - a parameter of a linear mean, with A = d mean / d param (p, N): gradient
          A W r over the summed residual columns r, Hessian n (A W) A^T, n the
          replicate columns ((..., p, 1) and (..., p, p));
        - anything else by autodiff through log_p (the base class).

        A Hessian built from data alone stays unbatched and broadcasts."""
        if param == self.response:
            Q = st.as_structured(self.precision.predictor(state))
            grad = -st.matvec(Q, state[self.response] - self.mean.predictor(state))
            if not hessian_required:
                return grad
            hessian = st.to_dense(Q)
            n = state[param].shape[-1]
            if n > 1:
                eye = torch.eye(n, dtype=hessian.dtype, device=hessian.device)
                p = hessian.shape[-1]
                hessian = (hessian[..., :, None, :, None] * eye[:, None, :]).reshape(hessian.shape[:-2] + (p * n, p * n))
            return grad, hessian
        linear = isinstance(self.mean, LinearCombination) and param in self.mean.get_grad_param_list()
        if not linear or param in self.precision.get_grad_param_list():
            return super().grad_log_p(state, param, hessian_required=hessian_required)
        Q = st.as_structured(self.precision.predictor(state))
        r = torch.sum(state[self.response] - self.mean.predictor(state), dim=-1, keepdim=True)
        grad_param = self.mean.grad(state, param)  # (p, N)
        grad_times_prec = st.matvec(Q, grad_param.mT).mT  # (..., p, N); Q stays structured
        grad = torch.matmul(grad_times_prec, r)
        if not hessian_required:
            return grad
        n = state[self.response].shape[-1]
        return grad, n * torch.matmul(grad_times_prec, grad_param.mT)

    def sample(self, key, state: dict, n: int = 1, batch_shape=()):
        """A draw from the Normal, (..., p, n); ``batch_shape`` gives the chains
        their own draws where mean and precision are data. A truncated Normal
        draws by :func:`gmrf.sample_truncated_normal`."""
        mean = self.mean.predictor(state)
        Q = st.as_structured(self.precision.predictor(state))
        if not self.truncated:
            return gmrf.sample_normal(key, mean, Q=Q, n=n, batch_shape=batch_shape)
        lo, hi = self._bounds(mean.device)
        return gmrf.sample_truncated_normal(key, mean, Q=Q, lower=lo, upper=hi, n=n, batch_shape=batch_shape)
