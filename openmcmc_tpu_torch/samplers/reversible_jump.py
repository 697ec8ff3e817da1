"""Reversible-jump MCMC on padded state (port of ``openmcmc_tpu/samplers/reversible_jump.py``).

Birth/death moves on a count parameter and its associated padded parameters
(:mod:`openmcmc_tpu_torch.padding`), all chains batched:

- the move type is drawn per chain, with the edge-case move probabilities;
- the birth and the death proposal are both computed for every chain and the
  chain's own move is selected;
- birth appends the new element at index ``count``; death deletes a uniformly
  chosen active element order-preservingly;
- prediction-matched coefficient transitions run on the padded basis matrices,
  with a unit diagonal on the inactive block, so the masked solves and log|det F|
  equal their dense sub-matrix counterparts.

As in the JAX package, the proposal density of a new element is its prior
density at the NEW value drawn (and at the DELETED value for the reverse of a
death). The symmetric factorizations are batched ``torch.linalg.cholesky_ex``;
the non-symmetric C of both matched transitions (the JAX package's unrolled
``smallmat`` elimination, a TPU workaround) is ``torch.linalg.lu_factor_ex``,
with log|det C| read from the LU diagonal and the death solve by ``lu_solve``.
Uniforms (move type, deletion index) come from the run's ``torch.Generator``;
the JAX package splits threefry keys.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from openmcmc_tpu_torch import padding
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.samplers.metropolis import MetropolisHastings

_RIDGE = 1e-6


def _count(state: dict, name: str) -> torch.Tensor:
    """The active count per chain as (..., 1, 1) int64."""
    c = state[name]
    return c.reshape(c.shape[:-2] + (1, 1)).to(torch.int64)


def _chol_log_det(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def _lu_log_abs_det(LU: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.log(torch.abs(torch.diagonal(LU, dim1=-2, dim2=-1))), dim=-1)


class ReversibleJump(MetropolisHastings):
    """Birth/death reversible jump on a count parameter plus associated padded params.

    Args:
        param: name of the integer count entry (e.g. "n_basis"): the number of
            active columns of every associated parameter.
        model: the FULL model (no conditional restriction).
        associated_params: names of padded (p, n_max) parameters gaining or losing
            a column on birth/death; new elements are drawn from their priors.
        n_max: the padded maximum (the padded width of the associated params).
        birth_probability: probability of proposing a birth away from the limits.
        state_birth_function / state_death_function: optional hooks for
            problem-specific updates (e.g. basis matrices):
            birth(key, current_state, prop_state) -> (prop_state, logp_fwd, logp_rev);
            death(key, current_state, prop_state, deletion_index) -> the same.
        matching_params: optional dict {"variable", "matrix", "scale", "limits"}
            enabling prediction-matched coefficient transitions: "variable" a
            padded (n_max, 1) coefficient vector, "matrix" a padded (n_data, n_max)
            basis matrix.
        updated_names: every state entry the sampler (hooks included) may modify;
            defaults to [param] + associated_params + the matching variable and matrix.
    """

    def __init__(
        self,
        param: str,
        model: Model,
        associated_params: Union[str, Sequence[str], None] = None,
        n_max: int = 0,
        birth_probability: float = 0.5,
        state_birth_function: Optional[Callable] = None,
        state_death_function: Optional[Callable] = None,
        matching_params: Optional[dict] = None,
        updated_names: Optional[List[str]] = None,
    ):
        self.param = param
        self.model = model  # full model, deliberately unrestricted
        self.max_variable_size = n_max
        if isinstance(associated_params, str):
            associated_params = [associated_params]
        self.associated_params = list(associated_params or [])
        self.n_max = int(n_max)
        if self.n_max <= 0:
            raise ValueError("ReversibleJump requires n_max > 0 (the padded maximum dimension)")
        self.birth_probability = float(birth_probability)
        self.state_birth_function = state_birth_function
        self.state_death_function = state_death_function
        self.matching_params = matching_params
        if updated_names is None:
            updated_names = [param] + self.associated_params
            if matching_params is not None:
                updated_names += [matching_params["variable"], matching_params["matrix"]]
        self._configure(0.0, param, list(dict.fromkeys(updated_names)), False, None, 0.05)

    # ------------------------------------------------------------------
    # move machinery
    # ------------------------------------------------------------------

    def get_move_probabilities(self, state: dict, birth: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-chain forward/reverse move probabilities with the edge corrections:
        a birth from n_max - 1 is reversed by a certain death, a death from 2 by a
        certain birth, and the limits 1 and n_max force their move."""
        k = _count(state, self.param)[..., 0, 0]
        f = dict(dtype=torch.float32, device=k.device)
        p_birth = torch.full(k.shape, self.birth_probability, **f)
        p_death = torch.full(k.shape, 1.0 - self.birth_probability, **f)
        p_death = torch.where(k == self.n_max, 1.0, p_death)
        if birth:
            p_death = torch.where(k == self.n_max - 1, 1.0, p_death)
        p_birth = torch.where(k == 1, 1.0, p_birth)
        if not birth:
            p_birth = torch.where(k == 2, 1.0, p_birth)
        return p_birth, p_death

    def _uniform(self, key, like: torch.Tensor) -> torch.Tensor:
        return torch.rand(like.shape, generator=key.generator, dtype=torch.float32, device=like.device)

    def proposal(self, key, state: dict, param_index=None, step=None):
        k = _count(state, self.param)[..., 0, 0]
        u = self._uniform(key, k)
        birth = torch.where(k == self.n_max, False, torch.where(k == 1, True, u <= self.birth_probability))

        b_updates, b_fwd, b_rev = self.birth_proposal(key, state)
        d_updates, d_fwd, d_rev = self.death_proposal(key, state)

        updates = {}
        for name in self.updated_names:
            bu = b_updates.get(name, state[name])
            du = d_updates.get(name, state[name])
            shape = torch.broadcast_shapes(bu.shape, du.shape)
            pick = birth.reshape(birth.shape + (1,) * (len(shape) - birth.dim()))
            updates[name] = torch.where(pick, bu, du)
        return updates, torch.where(birth, b_fwd, d_fwd), torch.where(birth, b_rev, d_rev)

    # ------------------------------------------------------------------
    # birth
    # ------------------------------------------------------------------

    def birth_proposal(self, key, state: dict):
        """Birth: count += 1; new elements drawn from their priors are appended at
        index ``count``."""
        k = _count(state, self.param)
        n_chains = k.shape[:-2]
        updates = {self.param: state[self.param] + 1}
        log_prop_density = 0.0
        for name in self.associated_params:
            dist = self.model[name]
            new_element = dist.sample(key, state, n=1, batch_shape=n_chains)  # (..., p, 1)
            updates[name] = padding.append(state[name], new_element, k, axis=1)
            log_prop_density = log_prop_density + self._element_log_p(dist, state, new_element)

        prop_state = dict(state)
        prop_state.update(updates)
        if self.state_birth_function is not None:
            prop_state, logp_pr_g_cr, logp_cr_g_pr = self.state_birth_function(key, state, prop_state)
        else:
            logp_pr_g_cr, logp_cr_g_pr = 0.0, 0.0
        if self.matching_params is not None:
            prop_state, logp_pr_g_cr, logp_cr_g_pr = self.matched_birth_transition(
                key, state, prop_state, logp_pr_g_cr, logp_cr_g_pr)

        p_birth, p_death = self.get_move_probabilities(state, True)
        logp_pr_g_cr = logp_pr_g_cr + torch.log(p_birth) + log_prop_density
        logp_cr_g_pr = logp_cr_g_pr + torch.log(p_death)
        return {name: prop_state[name] for name in self.updated_names}, logp_pr_g_cr, logp_cr_g_pr

    def _element_log_p(self, dist, state: dict, element: torch.Tensor) -> torch.Tensor:
        """Prior log-density of one new element (column) of an associated param,
        evaluated as an all-active single column; one value per chain."""
        sub = dict(state)
        sub[dist.response] = element
        if getattr(dist, "n_active", None):
            sub[dist.n_active] = torch.ones((1, 1), dtype=torch.int32, device=element.device)
        return dist.log_p(sub, by_observation=True)[..., 0]

    # ------------------------------------------------------------------
    # death
    # ------------------------------------------------------------------

    def death_proposal(self, key, state: dict):
        """Death: count -= 1; a uniformly chosen active column is deleted."""
        k = _count(state, self.param)
        # floor(u k) on [0, k - 1]; k >= 1 keeps the (selected-away) k = 0 case in range
        k_hi = torch.clamp(k, min=1)
        deletion_index = torch.minimum(torch.floor(self._uniform(key, k) * k_hi).to(torch.int64), k_hi - 1)

        updates = {self.param: state[self.param] - 1}
        log_prop_density = 0.0
        for name in self.associated_params:
            dist = self.model[name]
            deleted = padding.take_column(state[name], deletion_index, axis=1)
            updates[name] = padding.delete(state[name], deletion_index, k, axis=1)
            log_prop_density = log_prop_density + self._element_log_p(dist, state, deleted)

        prop_state = dict(state)
        prop_state.update(updates)
        if self.state_death_function is not None:
            prop_state, logp_pr_g_cr, logp_cr_g_pr = self.state_death_function(key, state, prop_state, deletion_index)
        else:
            logp_pr_g_cr, logp_cr_g_pr = 0.0, 0.0
        if self.matching_params is not None:
            prop_state, logp_pr_g_cr, logp_cr_g_pr = self.matched_death_transition(
                key, state, prop_state, logp_pr_g_cr, logp_cr_g_pr, deletion_index)

        p_birth, p_death = self.get_move_probabilities(state, False)
        logp_pr_g_cr = logp_pr_g_cr + torch.log(p_death)
        logp_cr_g_pr = logp_cr_g_pr + torch.log(p_birth) + log_prop_density
        return {name: prop_state[name] for name in self.updated_names}, logp_pr_g_cr, logp_cr_g_pr

    # ------------------------------------------------------------------
    # prediction-matched coefficient transitions
    # ------------------------------------------------------------------

    @staticmethod
    def _masked_gram(basis: torch.Tensor, count) -> torch.Tensor:
        """basis' basis plus a 1e-6 ridge on the active block and the identity on
        the inactive block (the padded basis columns are zero, so S[:, j] = e_j
        for inactive j: the property the determinant identities rely on)."""
        mask = padding.active_mask(count, basis.shape[-1], basis.dtype)
        return torch.matmul(basis.mT, basis) + torch.diag_embed(_RIDGE * mask + (1.0 - mask))

    def _coefficient_draw(self, key, mean: torch.Tensor):
        """The new coefficient around ``mean`` (..., 1, 1) and its log-density."""
        scale, limits = self.matching_params["scale"], self.matching_params["limits"]
        if limits is not None:
            draw = gmrf.truncated_normal_rv(key, mean, scale, lower=limits[0], upper=limits[1])
            log_q = gmrf.truncated_normal_log_pdf(draw, mean, scale, lower=limits[0], upper=limits[1])
        else:
            draw = mean + scale * torch.randn(mean.shape, generator=key.generator, dtype=mean.dtype, device=mean.device)
            z = (draw - mean) / scale
            log_q = -0.5 * (z * z + math.log(2.0 * math.pi)) - math.log(scale)
        return draw, log_q[..., 0, 0]

    def _coefficient_log_q(self, value: torch.Tensor) -> torch.Tensor:
        """Log-density of a deleted coefficient (..., 1, 1) under the proposal at 0."""
        scale, limits = self.matching_params["scale"], self.matching_params["limits"]
        if limits is not None:
            log_q = gmrf.truncated_normal_log_pdf(value, 0.0, scale, lower=limits[0], upper=limits[1])
        else:
            z = value / scale
            log_q = -0.5 * (z * z + math.log(2.0 * math.pi)) - math.log(scale)
        return log_q[..., 0, 0]

    def matched_birth_transition(self, key, current_state, prop_state, logp_pr_g_cr, logp_cr_g_pr):
        """Match predictions across a birth: beta* = G beta plus a noisy new
        coefficient. mu* = S^-1 B*' (B beta) with S the proposed basis's masked
        Gram, and log|det F| = log|det C| - log det S with C = S F assembled from
        the Gram blocks (column j of C: M[:, j] = (B*' B)[:, j] for j < k, S[:, k]
        at j = k, e_j on the inactive block)."""
        vector, matrix = self.matching_params["variable"], self.matching_params["matrix"]
        k = _count(current_state, self.param)  # count before the birth; the new coefficient at index k
        current_basis, prop_basis = current_state[matrix], prop_state[matrix]
        S = self._masked_gram(prop_basis, k + 1)
        chol_S, _ = torch.linalg.cholesky_ex(S)
        r = torch.matmul(current_basis, current_state[vector])  # (..., n_data, 1)
        mu_star = torch.cholesky_solve(torch.matmul(prop_basis.mT, r), chol_S)  # (..., n_max, 1)

        mu_new = padding.take_column(mu_star, k, axis=0)  # (..., 1, 1)
        draw, log_q = self._coefficient_draw(key, mu_new)
        logp_pr_g_cr = logp_pr_g_cr + log_q
        new_vector = padding.append(padding.mask_along_axis(mu_star, k, axis=0), draw, k, axis=0)
        prop_state = dict(prop_state)
        prop_state[vector] = new_vector

        idx = torch.arange(S.shape[-1], device=S.device)
        kk = k[..., 0, :]  # (..., 1): broadcasts over the column index
        M = torch.matmul(prop_basis.mT, current_basis)
        C = torch.where((idx < kk)[..., None, :], M, 0.0) + torch.where((idx == kk)[..., None, :], S, 0.0)
        C = C + torch.diag_embed((idx > kk).to(S.dtype).expand(S.shape[:-1]))
        LU, _, _ = torch.linalg.lu_factor_ex(C)
        logp_cr_g_pr = logp_cr_g_pr + _lu_log_abs_det(LU) - _chol_log_det(chol_S)
        return prop_state, logp_pr_g_cr, logp_cr_g_pr

    def matched_death_transition(self, key, current_state, prop_state, logp_pr_g_cr, logp_cr_g_pr, deletion_index):
        """The reverse of the birth matching: beta_aug = F^-1 beta, then the chosen
        coefficient is deleted. With S the current basis's masked Gram and C = S F
        (the column S[:, j] inserted into M = B' B_prop at the deletion position),
        one LU of C gives mu_aug = C^-1 (S beta) and log|det F| = log|det C| - log det S."""
        vector, matrix = self.matching_params["variable"], self.matching_params["matrix"]
        k = _count(current_state, self.param)  # count before the death
        current_basis, prop_basis = current_state[matrix], prop_state[matrix]
        S = self._masked_gram(current_basis, k)
        M = torch.matmul(current_basis.mT, prop_basis)
        idx = torch.arange(S.shape[-1], device=S.device)
        kk = k[..., 0, :]
        C = padding.insert_column(M, padding.take_column(S, deletion_index, axis=1), deletion_index)
        C = torch.where((idx < kk)[..., None, :], C, 0.0)
        C = C + torch.diag_embed((idx >= kk).to(S.dtype).expand(S.shape[:-1]))
        LU, pivots, _ = torch.linalg.lu_factor_ex(C)
        mu_aug = torch.linalg.lu_solve(LU, pivots, torch.matmul(S, current_state[vector]))
        chol_S, _ = torch.linalg.cholesky_ex(S)
        logdet_F = _lu_log_abs_det(LU) - _chol_log_det(chol_S)
        param_del = padding.take_column(mu_aug, deletion_index, axis=0)
        prop_state = dict(prop_state)
        prop_state[vector] = padding.delete(mu_aug, deletion_index, k, axis=0)
        return prop_state, logp_pr_g_cr + logdet_F, logp_cr_g_pr + self._coefficient_log_q(param_del)
