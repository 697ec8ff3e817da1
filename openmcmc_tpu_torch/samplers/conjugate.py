"""Conjugate Gibbs samplers (port of ``openmcmc_tpu/samplers/conjugate.py``).

Ported so far: :class:`NormalNormal` and :class:`NormalGamma` with their JAX
structural checks and their ``step`` on chain-batched state (per-chain entries
(chains, p, n), data (p, n), broadcast). NormalNormal keeps the conditional
precision structured, so a banded GMRF prior plus a diagonal likelihood stays
tridiagonal and its draw is one launch of kernel K3; a box-truncated prior takes
one red-black truncated Gibbs sweep over the current value instead. A
LinearCombination likelihood mean adds the dense Hessian n (X'W) X per chain,
and the draw factors the (chains, p, p) Dense precision with batched
``torch.linalg.cholesky_ex`` (no kernel: the JAX package leaves it to XLA). Not
ported yet, and raising with their ROADMAP.md item: the mixture likelihood
means (queue 1: mixture), the lexicographic truncated sweep a non-banded
precision needs (queue 1: sparse and permuted priors) and ``MixtureAllocation``
(queue 1: mixture).
"""

from __future__ import annotations

from typing import Tuple

import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.parameters import Identity, LinearCombination, ScaledMatrix
from openmcmc_tpu_torch.samplers.base import Sampler


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
            else:
                raise NotImplementedError(
                    f"NormalNormal with a {type(dist.mean).__name__} likelihood mean is not ported yet "
                    "(ROADMAP.md queue 1: mixture)"
                )
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
    """Gamma prior on the precision scalar of a Gaussian.

    Posterior: a* = a0 + n_eff / 2, b* = b0 + r' P r / 2, with P the unscaled
    precision (the identity for an Identity precision) and n_eff the count of
    its positive diagonal entries times the replicate columns."""

    def __init__(self, param: str, model: Model):
        super().__init__(param, model)
        normal_params = [k for k in self.model.keys() if k != param]
        if len(normal_params) != 1:
            raise TypeError("NormalGamma expects exactly one paired Normal distribution")
        self.normal_param = normal_params[0]
        if not isinstance(self.model[self.normal_param].precision, (Identity, ScaledMatrix)):
            raise TypeError("precision must be either Identity or ScaledMatrix in the port so far")

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

        if isinstance(precision, Identity):
            # precision == the sampled scalar itself: the unscaled penalty is the identity
            quad = torch.sum(residual * residual, dim=(-2, -1))
            a = a + residual.shape[-2] * n_obs / 2.0
        else:
            P = st.as_structured(state[precision.matrix])
            quad = torch.sum(residual * st.matvec(P, residual), dim=(-2, -1))
            n_eff = torch.sum(st.diag(P) > 0, dim=-1) * n_obs
            a = a + n_eff[..., None] / 2.0
        b = b + quad[..., None] / 2.0

        draw = torch._standard_gamma(a.contiguous(), generator=key.generator) / torch.where(b == 0, torch.inf, b)
        draw = torch.where(b == 0, torch.inf, draw)
        new_state = dict(state)
        new_state[param] = draw.reshape(x.shape)
        return new_state, stats
