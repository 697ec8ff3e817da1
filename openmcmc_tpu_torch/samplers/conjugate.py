"""Conjugate Gibbs samplers (port of ``openmcmc_tpu/samplers/conjugate.py``).

:class:`NormalNormal`, :class:`NormalGamma` and :class:`MixtureAllocation`
with their JAX structural checks and their ``step`` on chain-batched state
(per-chain entries (chains, p, n), data (p, n), broadcast). NormalNormal keeps
the conditional precision structured, so a banded GMRF prior plus a diagonal
likelihood stays tridiagonal and its draw is one launch of kernel K3; a
box-truncated prior takes one red-black truncated Gibbs sweep over the current
value instead. A LinearCombination likelihood mean adds the dense Hessian
n (X'W) X per chain, and the draw factors the (chains, p, p) Dense precision with
batched ``torch.linalg.cholesky_ex`` (no kernel: the JAX package leaves it to
XLA). A mixture likelihood mean (the component means) adds diag(n_k lam_k), so
the conditional stays Diagonal. Per-component sums over the allocation are
scatter-adds (the JAX package contracts with one-hot matrices, a TPU
workaround). The lexicographic truncated sweep a non-banded precision needs
raises with its ROADMAP.md item (queue 1: sparse and permuted priors).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.distributions.univariate import categorical_icdf
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.parameters import (
    Identity,
    LinearCombination,
    MixtureParameterMatrix,
    MixtureParameterVector,
    ScaledMatrix,
)
from openmcmc_tpu_torch.samplers.base import Sampler


def _component_sums(alloc: torch.Tensor, values: torch.Tensor, m: int) -> torch.Tensor:
    """Per-component sums of ``values`` (..., n) over the points allocated to
    each of the m components, for an allocation (..., n): (..., m)."""
    batch = torch.broadcast_shapes(alloc.shape[:-1], values.shape[:-1])
    n = alloc.shape[-1]
    out = torch.zeros(batch + (m,), dtype=values.dtype, device=values.device)
    return out.scatter_add_(-1, alloc.to(torch.int64).expand(batch + (n,)), values.expand(batch + (n,)))


class NormalNormal(Sampler):
    """Gaussian prior x Gaussian likelihood(s) with linear mean dependence.

    Conditional: Q = P + sum_k n_k W_k ; b = P m + sum_k W_k sum_cols(y_k); draw
    from N(Q^-1 b, Q^-1) by the canonical sampler, or take one truncated Gibbs
    sweep of it when the prior has domain limits."""

    def __init__(self, param: str, model: Model):
        super().__init__(param, model)
        self._is_response = {key: key == param for key in self.model.keys()}
        if not isinstance(self.model[param], Normal):
            raise TypeError("NormalNormal requires a Normal prior on the sampled parameter")

    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        param = self.param
        Q = None
        x = state[param]
        b = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
        for key_r, dist in self.model.items():
            Q_rsp = st.as_structured(dist.precision.predictor(state))
            if self._is_response[key_r]:
                Q = Q_rsp if Q is None else st.add(Q, Q_rsp)
                b = b + st.matvec(Q_rsp, dist.mean.predictor(state))
                continue
            if isinstance(dist.mean, Identity):
                # Hessian n W, structured, so GMRF bandedness survives
                n_obs = state[key_r].shape[-1]
                Q_dist = st.scale(float(n_obs), Q_rsp)
                b = b + st.matvec(Q_rsp, torch.sum(state[key_r], dim=-1, keepdim=True))
            elif isinstance(dist.mean, LinearCombination):
                # Q += n (X'W) X, b += X'W (y - the other terms), per chain
                _, Q_dense = dist.grad_log_p(state, param)
                Q_dist = st.Dense(Q_dense)
                rest = dist.mean.predictor_conditional(state, term_to_exclude=param)
                A = state[dist.mean.form_dict[param]]
                b = b + torch.matmul(A.mT, st.matvec(Q_rsp, state[key_r] - rest))
            elif isinstance(dist.mean, MixtureParameterVector) and dist.mean.param == param:
                # component means: the design is the one-hot allocation A (n, m),
                # so Q += n_obs A'WA and b += A'W sum_cols(y); A'WA is Diagonal
                # when W is
                alloc = dist.mean.indices(state)
                m = x.shape[-2]
                n_obs = state[key_r].shape[-1]
                y_sum = torch.sum(state[key_r], dim=-1)
                if isinstance(Q_rsp, st.Diagonal):
                    Q_dist = st.Diagonal(_component_sums(alloc, Q_rsp.diag_, m) * float(n_obs))
                    b = b + _component_sums(alloc, Q_rsp.diag_ * y_sum, m)[..., None]
                else:
                    onehot = (alloc[..., None] == torch.arange(m, device=alloc.device)).to(b.dtype)
                    WA = st.matvec(Q_rsp, onehot)
                    Q_dist = st.Dense(torch.matmul(onehot.mT, WA) * float(n_obs))
                    b = b + torch.matmul(WA.mT, y_sum[..., None])
            else:
                raise TypeError(f"NormalNormal cannot take a {type(dist.mean).__name__} likelihood mean of {param}")
            Q = Q_dist if Q is None else st.add(Q, Q_dist)
        prior = self.model[param]
        if not prior.truncated:
            new_value = gmrf.sample_normal_canonical(key, b, Q=Q)
        else:
            # the chromatic sweep conditions on the current x: bw + 1 colour updates
            lo, hi = prior._bounds(x.device)
            schedule = "red_black" if isinstance(Q, (st.Banded, st.Diagonal)) else "lex"
            new_value = gmrf.gibbs_canonical_truncated_normal(key, b, Q, x, lower=lo, upper=hi, schedule=schedule)
        new_state = dict(state)
        new_state[param] = new_value.reshape(x.shape)
        return new_state, stats


class NormalGamma(Sampler):
    """Gamma prior on the precision scalar(s) of a Gaussian.

    Posterior: a* = a0 + n_eff / 2, b* = b0 + r' P r / 2, with P the unscaled
    precision (the identity for an Identity precision) and n_eff the count of
    its positive diagonal entries times the replicate columns. A
    MixtureParameterMatrix precision has one precision per component k:
    a*_k = a0_k + count_k / 2 and b*_k = b0_k + quad_k / 2 over the points (and
    replicate columns) allocated to k."""

    def __init__(self, param: str, model: Model):
        super().__init__(param, model)
        normal_params = [k for k in self.model.keys() if k != param]
        if len(normal_params) != 1:
            raise TypeError("NormalGamma expects exactly one paired Normal distribution")
        self.normal_param = normal_params[0]
        if not isinstance(self.model[self.normal_param].precision, (Identity, ScaledMatrix, MixtureParameterMatrix)):
            raise TypeError("precision must be either Identity, ScaledMatrix or MixtureParameterMatrix")

    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        param = self.param
        normal_dist = self.model[self.normal_param]
        precision = normal_dist.precision
        residual = state[normal_dist.response] - normal_dist.mean.predictor(state)  # (..., p_y, n)
        n_obs = residual.shape[-1]

        shape_in = self.model[param].shape.predictor(state)
        rate_in = self.model[param].rate.predictor(state)
        x = state[param]
        batch = torch.broadcast_shapes(x.shape[:-2], residual.shape[:-2])
        m = x.shape[-2]
        a = shape_in.reshape(shape_in.shape[:-2] + (-1,)).expand(batch + (m,))
        b = rate_in.reshape(rate_in.shape[:-2] + (-1,)).expand(batch + (m,))

        if isinstance(precision, MixtureParameterMatrix):
            alloc = precision.indices(state)
            quad = _component_sums(alloc, torch.sum(residual * residual, dim=-1), m)
            ones = torch.ones(alloc.shape, dtype=residual.dtype, device=residual.device)
            a = a + n_obs * _component_sums(alloc, ones, m) / 2.0
        elif isinstance(precision, Identity):
            # precision == the sampled scalar itself: the unscaled penalty is the identity
            quad = torch.sum(residual * residual, dim=(-2, -1))[..., None]
            a = a + residual.shape[-2] * n_obs / 2.0
        else:
            P = st.as_structured(state[precision.matrix])
            quad = torch.sum(residual * st.matvec(P, residual), dim=(-2, -1))[..., None]
            n_eff = torch.sum(st.diag(P) > 0, dim=-1) * n_obs
            a = a + n_eff[..., None] / 2.0
        b = b + quad / 2.0

        draw = torch._standard_gamma(a.contiguous(), generator=key.generator) / torch.where(b == 0, torch.inf, b)
        draw = torch.where(b == 0, torch.inf, draw)
        new_state = dict(state)
        new_state[param] = draw.reshape(x.shape)
        return new_state, stats


class MixtureAllocation(Sampler):
    """Conjugate allocation of each point of a Normal mixture to a component.

    Conditional probabilities gam_ik proportional to prior_ik N(y_i; mu_k,
    1/lam_k), one categorical draw per point and chain, by inverse CDF from one
    uniform of the run's generator (the JAX package draws
    ``jax.random.categorical``; the two agree in distribution)."""

    def __init__(self, param: str, model: Model, response_param: str):
        # only the allocation prior and the mixture response distribution
        self.param = param
        self.response_param = response_param
        self.max_variable_size = None
        self.model = Model([model[param], model[response_param]])
        response = self.model[response_param]
        if not isinstance(response, Normal):
            raise TypeError("Mixture model currently only implemented for Normal case")
        if not isinstance(response.mean, MixtureParameterVector):
            raise TypeError("Mean must be of type MixtureParameterVector")
        if not isinstance(response.precision, MixtureParameterMatrix):
            raise TypeError("Precision must be of type MixtureParameterMatrix")

    def logits(self, state: dict) -> torch.Tensor:
        """log prior_ik + log N(y_i; mu_k, 1/lam_k), (..., n, m), in the JAX
        package's operation order."""
        response = self.model[self.response_param]
        prior = self.model[self.param].prob.predictor(state)  # (n, m)
        y = state[self.response_param]  # (n, 1)
        mu = state[response.mean.param]
        lam = state[response.precision.param]
        mu = mu.reshape(mu.shape[:-2] + (1, -1))
        lam = lam.reshape(lam.shape[:-2] + (1, -1))
        z2 = (y - mu) ** 2 * lam
        log_like = 0.5 * (torch.log(lam) - math.log(2.0 * math.pi) - z2)
        return torch.log(prior) + log_like

    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        logits = self.logits(state)
        weights = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
        u = torch.rand(weights.shape[:-1], generator=key.generator, dtype=weights.dtype, device=weights.device)
        draw = categorical_icdf(weights, u)
        x = state[self.param]
        new_state = dict(state)
        new_state[self.param] = draw.reshape(draw.shape[:-1] + tuple(x.shape[-2:])).to(x.dtype)
        return new_state, stats
