"""Metropolis-Hastings family: RandomWalk, RandomWalkLoop, ManifoldMALA (port of
``openmcmc_tpu/samplers/metropolis.py``).

Every step runs all chains at once: the per-chain entries carry a leading chain
axis, so log-densities, proposal densities and accept decisions are (chains,)
tensors. Accept/reject is branchless (``torch.where``), and proposals return
only the entries they modify. Statistics are per chain: ``accept`` and
``proposal`` counters (int32), ``log_step`` while adapting, and the carried
current-state log-density ``logp`` when the driver seeds it (see
:class:`MetropolisHastings`). Randomness comes from the key's ``torch.Generator``
(the JAX package splits threefry keys): proposal noise, truncated-draw uniforms
and the accept uniforms, in that order. Nothing is read back from the device.

``active_count`` names an integer count entry (the padded reversible-jump
convention, :mod:`openmcmc_tpu_torch.padding`): entries of the parameter at or
past the count are frozen. ``RandomWalkLoop`` then proposes and counts only the
active columns, and ``ManifoldMALA`` keeps the inactive rows of its proposal at
their current values. A ``NullDistribution`` contributes zero to every density,
so it never couples the columns of ``RandomWalkLoop``'s vectorized step.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.padding import active_mask
from openmcmc_tpu_torch.samplers.base import Sampler


def acceptance_rate(stats: dict) -> torch.Tensor:
    """Percentage of proposals accepted, per chain, from a sampler's stats."""
    return 100.0 * stats["accept"] / torch.clamp(stats["proposal"], min=1)


def _expand_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (batch,) with trailing unit axes to broadcast against ``like`` (batch, ...)."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


class MetropolisHastings(Sampler):
    """Abstract MH sampler: subclasses implement ``proposal(key, state, ...) ->
    (updates, logp_pr_g_cr, logp_cr_g_pr)``, ``updates`` holding only the entries
    the proposal modifies.

    Carried log-density: when the driver finds that no other sampler of the
    sweep modifies this sampler's model inputs, it seeds a ``logp`` entry in the
    stats; a step then evaluates only the proposal's density and writes back the
    post-accept value where(accept, logp_proposal, logp_current)."""

    #: default acceptance-rate target for step adaptation (overridden per subclass)
    default_target_accept = 0.234

    def __init__(self, param: str, model: Model, step=0.2, active_count=None, updated_names=None,
                 adapt_step: bool = False, target_accept: Optional[float] = None, adapt_rate: float = 0.05):
        super().__init__(param, model)
        self._configure(step, active_count, updated_names, adapt_step, target_accept, adapt_rate)

    def _configure(self, step, active_count, updated_names, adapt_step, target_accept, adapt_rate):
        # step size kept under step_size (.step is the update method), at least 2-D
        self.step_size = torch.as_tensor(np.atleast_2d(np.asarray(step, dtype=np.float32)))
        self.active_count = active_count
        self.updated_names = updated_names if updated_names is not None else [self.param]
        # Robbins-Monro adaptation of log(step) toward the target acceptance rate
        # during burn-in, per chain; frozen once sampling starts
        self.adapt_step = bool(adapt_step)
        self.target_accept = float(target_accept) if target_accept is not None else self.default_target_accept
        self.adapt_rate = float(adapt_rate)
        self._on_device = {}

    def _device_copy(self, name: str, value: torch.Tensor, device) -> torch.Tensor:
        """A constant of the sampler on ``device``, copied there once."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = value.to(device)
        return self._on_device[key]

    def init_stats(self):
        stats = {"accept": torch.zeros((), dtype=torch.int32), "proposal": torch.zeros((), dtype=torch.int32)}
        if self.adapt_step:
            stats["log_step"] = torch.log(self.step_size)
        return stats

    def _step_value(self, stats: dict, device):
        if self.adapt_step and "log_step" in stats:
            return torch.exp(stats["log_step"])
        return self._device_copy("step", self.step_size, device)

    def _adapt(self, stats: dict, log_accept, adapt: bool) -> dict:
        if not self.adapt_step or not adapt:
            return stats
        alpha = torch.exp(torch.clamp(log_accept, max=0.0))
        new_stats = dict(stats)
        nudge = self.adapt_rate * (alpha - self.target_accept)
        new_stats["log_step"] = stats["log_step"] + _expand_as(nudge, stats["log_step"])
        return new_stats

    def proposal(self, key, state: dict, param_index=None, step=None):
        raise NotImplementedError

    def _conditional_log_p(self, state: dict) -> torch.Tensor:
        total = 0.0
        for dist in self.model.values():
            total = total + dist.log_p(state)
        return total

    def _accept_reject(self, key, state, updates, logp_pr_g_cr, logp_cr_g_pr, stats, force_reject=None,
                       logp_cs=None):
        """Branchless accept/reject of all chains; ``logp_cs`` is the carried
        current-state log-density when the driver seeded one, and
        ``force_reject`` (per chain) turns an accept into a reject."""
        prop_state = dict(state)
        prop_state.update(updates)
        if logp_cs is None:
            logp_cs = self._conditional_log_p(state)
        logp_pr = self._conditional_log_p(prop_state)
        log_accept = logp_pr + logp_cr_g_pr - (logp_cs + logp_pr_g_cr)
        u = torch.rand(log_accept.shape, generator=key.generator, dtype=log_accept.dtype, device=log_accept.device)
        accept = torch.log(u) < log_accept
        if force_reject is not None:
            accept = accept & ~force_reject
        new_state = dict(state)
        for name, proposed in updates.items():
            new_state[name] = torch.where(_expand_as(accept, proposed), proposed, state[name])
        new_stats = dict(stats)
        new_stats["accept"] = stats["accept"] + accept.to(torch.int32)
        new_stats["proposal"] = stats["proposal"] + 1
        if "logp" in stats:
            new_stats["logp"] = torch.where(accept, logp_pr, logp_cs)
        return new_state, new_stats, log_accept

    def initial_carried_logp(self, state: dict) -> torch.Tensor:
        """Value of the carried log-density entry for the initial state."""
        return torch.as_tensor(self._conditional_log_p(state))

    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        step = self._step_value(stats, state[self.param].device)
        updates, logp_pr_g_cr, logp_cr_g_pr = self.proposal(key, state, step=step)
        # without a carried value (several samplers sharing inputs, or a bare
        # step() outside MCMC) the current density is recomputed
        new_state, new_stats, log_accept = self._accept_reject(
            key, state, updates, logp_pr_g_cr, logp_cr_g_pr, stats, logp_cs=stats.get("logp"))
        return new_state, self._adapt(new_stats, log_accept, adapt)


class RandomWalk(MetropolisHastings):
    """(Truncated) Gaussian random-walk proposals.

    ``domain_limits`` is a (p, 2) array of [lower, upper] proposal truncation
    bounds (the proposal is then asymmetric and both densities enter the accept
    ratio); ``state_update_function(key, prop_updates, state, param_index) ->
    (prop_updates, logp_fwd, logp_rev)`` optionally recomputes dependent entries
    for the proposal, and then the full model is kept."""

    default_target_accept = 0.234

    def __init__(self, param: str, model: Model, step=0.2, domain_limits=None,
                 state_update_function: Optional[Callable] = None, active_count=None, updated_names=None,
                 adapt_step: bool = False, target_accept: Optional[float] = None, adapt_rate: float = 0.05):
        self.param = param
        self.state_update_function = state_update_function
        self.model = model if state_update_function is not None else model.conditional(param)
        self.domain_limits = None if domain_limits is None else np.asarray(domain_limits, dtype=float)
        self._configure(step, active_count, updated_names, adapt_step, target_accept, adapt_rate)

    def _bounds(self, device):
        """The proposal box as (p, 1) float32 columns on ``device``."""
        lb = torch.as_tensor(self.domain_limits[:, 0], dtype=torch.float32).reshape(-1, 1)
        ub = torch.as_tensor(self.domain_limits[:, 1], dtype=torch.float32).reshape(-1, 1)
        return self._device_copy("lb", lb, device), self._device_copy("ub", ub, device)

    def _raw(self, key, value):
        """The variates a proposal for ``value`` turns into a draw: standard
        normals, or the truncated walk's inverse-CDF uniforms."""
        draw = torch.randn if self.domain_limits is None else torch.rand
        return draw(value.shape, generator=key.generator, dtype=value.dtype, device=value.device)

    def _draw(self, key, mu, step, raw=None):
        """Proposal z around mu with its forward and reverse log-densities per
        element (zeros for the symmetric Gaussian walk); ``raw`` is the
        :meth:`_raw` variates when drawn beforehand."""
        if raw is None:
            raw = self._raw(key, mu)
        if self.domain_limits is None:
            return mu + step * raw, None, None
        lb, ub = self._bounds(mu.device)
        z = gmrf.truncated_normal_rv(key, mu, step, lower=lb, upper=ub, shape=mu.shape, u=raw)
        fwd = gmrf.truncated_normal_log_pdf(z, mu, step, lower=lb, upper=ub)
        rev = gmrf.truncated_normal_log_pdf(mu, z, step, lower=lb, upper=ub)
        return z, fwd, rev

    def proposal(self, key, state: dict, param_index=None, step=None, raw=None):
        value = state[self.param]
        step_size = self._step_value({}, value.device) if step is None else step
        if param_index is None:
            mu, step = value, step_size
        else:
            mu = value[..., :, param_index:param_index + 1]
            step = step_size if step_size.shape[-1] == 1 else step_size[..., :, param_index:param_index + 1]
        z, fwd, rev = self._draw(key, mu, step, raw)
        batch = value.shape[:-2]
        zero = torch.zeros(batch, dtype=value.dtype, device=value.device)
        logp_pr_g_cr = zero if fwd is None else torch.sum(fwd, dim=(-2, -1))
        logp_cr_g_pr = zero if rev is None else torch.sum(rev, dim=(-2, -1))
        if param_index is None:
            proposed = z
        else:
            column = torch.arange(value.shape[-1], device=value.device) == param_index
            proposed = torch.where(column, z, value)
        updates = {self.param: proposed}
        if self.state_update_function is not None:
            updates, logp_fwd, logp_rev = self.state_update_function(key, updates, state, param_index)
            logp_pr_g_cr = logp_pr_g_cr + logp_fwd
            logp_cr_g_pr = logp_cr_g_pr + logp_rev
        return updates, logp_pr_g_cr, logp_cr_g_pr


class RandomWalkLoop(RandomWalk):
    """One-at-a-time RW update over the n replicate columns of the parameter.

    The evaluated model is restricted to the distributions that read one of
    ``updated_names`` (every other term cancels in the accept ratio), and the
    current state's density is computed once and carried through the columns.
    When that restricted model factorizes per column (each distribution a
    column-factorized prior on the parameter itself), the n sequential
    single-column kernels commute and one vectorized step with independent
    per-column accept decisions is the same composite kernel; dependent entries
    are then refreshed once after the accept by ``vector_state_update_function
    (key, updates, state) -> updates``. Otherwise the columns run in order, a
    Python loop in place of the JAX package's ``lax.scan``, with every column's
    proposal variates drawn before the loop."""

    default_target_accept = 0.44  # 1-D optimal acceptance

    def __init__(self, *args, vector_state_update_function: Optional[Callable] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.vector_state_update_function = vector_state_update_function

    def _loop_distributions(self):
        dists = getattr(self, "_loop_dists", None)
        if dists is None:
            names = set(self.updated_names)
            dists = [d for d in self.model.values() if names.intersection(d.param_list)]
            self._loop_dists = dists
        return dists

    def _vectorized_ok(self) -> bool:
        """True when the one-at-a-time sweep provably equals one vectorized step."""
        from openmcmc_tpu_torch.distributions.location_scale import NullDistribution

        cached = getattr(self, "_vec_ok", None)
        if cached is not None:
            return cached
        ok = not (self.state_update_function is not None and self.vector_state_update_function is None)
        for d in self._loop_distributions():
            if isinstance(d, NullDistribution):
                continue  # identically zero: cannot couple columns
            if d.response == self.param and getattr(d, "column_factorized", False) and self.param not in d._dist_params:
                continue  # own-column prior term
            ok = False
        self._vec_ok = ok
        return ok

    def _loop_log_p(self, state: dict) -> torch.Tensor:
        total = 0.0
        for dist in self._loop_distributions():
            total = total + dist.log_p(state)
        return total

    def _loop_log_p_columns(self, state: dict) -> torch.Tensor:
        """Per-column restricted log-density (..., n), valid when _vectorized_ok."""
        from openmcmc_tpu_torch.distributions.location_scale import NullDistribution

        total = 0.0
        for dist in self._loop_distributions():
            if not isinstance(dist, NullDistribution):
                total = total + dist.log_p(state, by_observation=True)
        return total

    def _active_columns(self, state: dict, n: int):
        """(..., n) bool mask of the columns below the active count, or None."""
        if self.active_count is None:
            return None
        return active_mask(state[self.active_count], n)

    def _step_vectorized(self, key, state: dict, stats: dict, adapt: bool) -> Tuple[dict, dict]:
        value = state[self.param]  # (..., p, n)
        z, fwd, rev = self._draw(key, value, self._step_value(stats, value.device))
        lf = 0.0 if fwd is None else torch.sum(fwd, dim=-2)
        lr = 0.0 if rev is None else torch.sum(rev, dim=-2)
        prop_state = dict(state)
        prop_state[self.param] = z
        log_accept = self._loop_log_p_columns(prop_state) + lr - (self._loop_log_p_columns(state) + lf)
        n = value.shape[-1]
        u = torch.rand(log_accept.shape, generator=key.generator, dtype=value.dtype, device=value.device)
        accept = torch.log(u) < log_accept
        active = self._active_columns(state, n)
        if active is not None:
            accept = accept & active
        updates = {self.param: torch.where(accept[..., None, :], z, value)}
        if self.vector_state_update_function is not None:
            updates = self.vector_state_update_function(key, updates, state)
        new_state = dict(state)
        new_state.update(updates)
        new_stats = dict(stats)
        new_stats["accept"] = stats["accept"] + torch.sum(accept, dim=-1).to(torch.int32)
        n_prop = n if active is None else torch.sum(active, dim=-1).to(torch.int32)
        new_stats["proposal"] = stats["proposal"] + n_prop
        if self.adapt_step and adapt:
            # one nudge per active column, summed: the sequential path's total per sweep
            alpha = torch.exp(torch.clamp(log_accept, max=0.0))
            nudge = alpha - self.target_accept
            if active is not None:
                nudge = torch.where(active, nudge, 0.0)
            total = torch.sum(nudge, dim=-1)
            new_stats["log_step"] = stats["log_step"] + _expand_as(self.adapt_rate * total, stats["log_step"])
        return new_state, new_stats

    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        if self._vectorized_ok():
            return self._step_vectorized(key, state, stats, adapt)
        n = state[self.param].shape[-1]
        carried = list(dict.fromkeys(self.updated_names))  # param + hook-updated entries
        values = {name: state[name] for name in carried}
        logp_cur = self._loop_log_p(state)
        active_cols = self._active_columns(state, n)
        sts = stats
        # every column's variates in one draw; each column's proposal applies the
        # step as adapted by the columns before it
        raw = self._raw(key, state[self.param])
        for idx in range(n):
            cur_state = dict(state)
            cur_state.update(values)
            device = cur_state[self.param].device
            updates, lf, lr = self.proposal(key, cur_state, param_index=idx, step=self._step_value(sts, device),
                                            raw=raw[..., :, idx:idx + 1])
            prop_state = dict(cur_state)
            prop_state.update(updates)
            logp_pr = self._loop_log_p(prop_state)
            log_accept = logp_pr + lr - (logp_cur + lf)
            u = torch.rand(log_accept.shape, generator=key.generator, dtype=log_accept.dtype, device=device)
            accept = torch.log(u) < log_accept
            active = None if active_cols is None else active_cols[..., idx]
            if active is not None:
                accept = accept & active
            values = {name: torch.where(_expand_as(accept, cur_state[name]), updates.get(name, cur_state[name]),
                                        cur_state[name]) for name in carried}
            logp_cur = torch.where(accept, logp_pr, logp_cur)
            old = sts
            sts = dict(sts)
            sts["accept"] = sts["accept"] + accept.to(torch.int32)
            sts["proposal"] = sts["proposal"] + (1 if active is None else active.to(torch.int32))
            sts = self._adapt(sts, log_accept, adapt)
            if active is not None and "log_step" in sts:
                sts["log_step"] = torch.where(_expand_as(active, old["log_step"]), sts["log_step"], old["log_step"])
        new_state = dict(state)
        new_state.update(values)
        return new_state, sts


class ManifoldMALA(MetropolisHastings):
    """Simplified manifold MALA (Girolami & Calderhead 2011).

    Proposal: N(theta + 1/2 s^2 H^-1 g, s^2 H^-1), H the model's negative Hessian
    at theta; the forward and the reverse proposal each take a gradient, a
    Hessian and a Cholesky factorization, batched over chains (a Hessian built
    from data alone is factored once for all chains)."""

    default_target_accept = 0.574  # MALA-optimal acceptance

    def proposal(self, key, state: dict, param_index=None, step=None):
        x = state[self.param]
        step = self._step_value({}, x.device) if step is None else step
        mu_cr, chol_cr = self._proposal_params(state, step)
        d = x.shape[-2] * x.shape[-1]
        flat_mu = mu_cr.reshape(mu_cr.shape[:-2] + (d, 1))
        proposed = gmrf.sample_normal(key, flat_mu, L=chol_cr).reshape(x.shape)
        if self.active_count is not None:
            # padded reversible-jump convention: the rows past the count stay (their
            # Hessian rows are the identity and their gradient zero, so their
            # forward and reverse proposal terms cancel in the accept ratio)
            mask = active_mask(state[self.active_count], x.shape[-2], dtype=proposed.dtype)[..., None]
            proposed = mask * proposed + (1.0 - mask) * x
        updates = {self.param: proposed}
        prop_state = dict(state)
        prop_state.update(updates)
        logp_pr_g_cr = self._log_proposal_density(proposed, mu_cr, chol_cr)
        mu_pr, chol_pr = self._proposal_params(prop_state, step)
        logp_cr_g_pr = self._log_proposal_density(x, mu_pr, chol_pr)
        return updates, logp_pr_g_cr, logp_cr_g_pr

    def _proposal_params(self, state: dict, step_size):
        grad, hessian = self.model.grad_log_p(state, param=self.param, hessian_required=True)
        x = state[self.param]
        d = x.shape[-2] * x.shape[-1]
        step2 = step_size * step_size
        chol = st.cholesky(st.Dense(hessian / step2))
        drift = st.cho_solve(chol, grad.reshape(grad.shape[:-2] + (d, 1)))
        mu = x + 0.5 * drift.reshape(drift.shape[:-2] + x.shape[-2:])
        return mu, chol

    def _log_proposal_density(self, value, mu, chol) -> torch.Tensor:
        r = value - mu
        w = st.chol_matvec_t(chol, r.reshape(r.shape[:-2] + (-1, 1)))
        return torch.sum(torch.log(st.diag(chol)), dim=-1) - 0.5 * torch.sum(w * w, dim=(-2, -1))
