"""Automatic fused-engine dispatch (port of ``openmcmc_tpu/fused/dispatch.py``).

``MCMC.run(engine="auto")`` calls :func:`match_fused_engine`. Matching is
structural (distribution types, parameter forms, sampler order) plus checks on
the constants the engines assume, exactly as in the JAX package. A failed match
returns None and the driver falls back to the generic driver, as in the JAX
package.

Ported so far, tried in the JAX package's order: the smoother matcher, routed
as in the JAX package to the spectral engine (kernel K1) or to the Thomas-scan
engine (kernel K4) for a tridiagonal P0 with p > 1024 (``fused_gmrf_smoother``)
or a box-truncated latent prior (``fused_gmrf_smoother_truncated``); then the
linear-regression matcher, to the unrolled-Cholesky engine for p <= 16
(``fused_linreg``, kernel K6) or the spectral one for p <= 256
(``fused_linreg_spectral``, kernel K5); then the random-walk matcher
(``fused_random_walk``, kernel K7) and the mMALA matcher, to the engine with a
precomputed Cholesky for p <= 16 (``fused_mmala``, kernel K8) or the spectral one
for p <= 256 (``fused_mmala_spectral``, kernel K9); then the Gaussian-mixture
matcher, to the mixture engine with a random walk on the component means
(``fused_mixture``) or their conjugate draw (``fused_mixture_conjugate``), both
kernel K10; and between the last two, as in the JAX package, the
reversible-jump matcher (``fused_rj``, kernel K11) for the knot-basis regression
with a Null or a Gaussian likelihood. The Metropolis runners return the JAX
package's statistics: accept and proposal counts over burn-in and sampling, and
the adapted log_step.

Resume, as the JAX package gates it: a runner that sets ``supports_resume``
(and whose ``resume_ok``, where it has one, accepts the result) is bound to the
resumed result and continues its chains from per-chain warm rows with no
burn-in. The smoother (K1, K4), linear-regression (K5, K6) and reversible-jump
(K11) runners do; the random-walk, mMALA and mixture runners not yet, since
their kernels take shared initial values only, so a resume of those falls
back to the generic driver under ``"auto"``. Mesh sharding is not ported
(ROADMAP.md queue 1: parallel).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.distributions.univariate import Categorical, Gamma
from openmcmc_tpu_torch.fused.layout import to_host
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.parameters import (
    Identity,
    LinearCombination,
    MixtureParameterMatrix,
    MixtureParameterVector,
    ScaledMatrix,
)
from openmcmc_tpu_torch.samplers.conjugate import MixtureAllocation, NormalGamma, NormalNormal
from openmcmc_tpu_torch.samplers.metropolis import ManifoldMALA, RandomWalk, RandomWalkLoop


def _scalar(mcmc, name) -> Optional[float]:
    value = mcmc.data.get(name)
    if value is None or isinstance(value, st.STRUCTURED_TYPES):
        return None
    if value.numel() != 1:
        return None
    return float(to_host(value.reshape(())))


def _column(value) -> Optional[np.ndarray]:
    """The single replicate column of a state entry as a 1-D host array, or None
    when the entry has several replicate columns (the single-column engines
    cannot represent them)."""
    if value is None or isinstance(value, st.STRUCTURED_TYPES):
        return None
    arr = to_host(value).numpy()
    if arr.ndim <= 1:
        return arr.reshape(-1)
    if arr.ndim == 2 and arr.shape[1] == 1:
        return arr[:, 0]
    return None


def _initial_scalar(mcmc, name) -> Optional[float]:
    value = mcmc.initial_chain_state.get(name)
    if value is None or value.numel() != 1:
        return None
    return float(to_host(value.reshape(())))


def _identity_mean_name(dist) -> Optional[str]:
    if isinstance(dist.mean, Identity):
        return dist.mean.form
    return None


def _scaled_precision(dist):
    """(matrix_name, scale_name) for a ScaledMatrix precision, else None."""
    if isinstance(dist.precision, ScaledMatrix):
        return dist.precision.matrix, dist.precision.scalar
    return None


def match_fused_engine(mcmc, resume=None) -> Optional[Callable]:
    """Return a callable ``runner(seed, bit_source=None)`` running the MCMC as a
    fused engine, or None; given a ``resume`` result, one that continues its
    chains, or None when the matched engine cannot resume from it.

    Thinning: the matcher sees a shallow clone whose ``n_burn`` is the SWEEP count
    (n_burn * n_thin) and whose ``_kernel_thin`` the engines apply in-kernel."""
    matched = mcmc
    if mcmc.n_thin != 1:
        matched = copy.copy(mcmc)
        matched.n_burn = mcmc.n_burn * mcmc.n_thin
        matched.n_thin = 1
        matched._kernel_thin = mcmc.n_thin
    for matcher in (_match_smoother, _match_linreg, _match_rw, _match_mmala, _match_rj, _match_mixture):
        runner = matcher(matched)
        if runner is not None:
            if mcmc.model.response is not None and not _fitted_ok(mcmc, runner):
                return None
            if resume is not None:
                if not getattr(runner, "supports_resume", False):
                    return None
                resume_ok = getattr(runner, "resume_ok", None)
                if resume_ok is not None and not resume_ok(resume):
                    return None
                bound = functools.partial(runner, resume=resume)
                bound.engine_name = runner.engine_name
                bound.store_keys = runner.store_keys
                runner = bound
            return runner
    return None


def _final_rows(resume, *names):
    """Each named final-state entry of a resumed result as a flat (chains,) row."""
    return [resume.final_state[name].reshape(-1) for name in names]


def _fitted_ok(mcmc, runner) -> bool:
    """Can the driver recompute every requested fitted response from constant data
    and the store the matched engine returns?"""
    available = set(mcmc.data) | set(getattr(runner, "store_keys", ()))
    for response, predictor_name in mcmc.model.response.items():
        predictor = getattr(mcmc.model.get(response), predictor_name, None)
        if predictor is None or not set(predictor.get_param_list()) <= available:
            return False
    return True


def _kernel_thin(mcmc) -> int:
    """The n_thin the matched clone's engines apply in-kernel."""
    return getattr(mcmc, "_kernel_thin", 1)


def _conjugate_triplet(mcmc):
    """NormalNormal(x) + two NormalGammas: (latent_name, gamma_params) or None."""
    if len(mcmc.samplers) != 3:
        return None
    nn, g1, g2 = mcmc.samplers
    if not isinstance(nn, NormalNormal) or not isinstance(g1, NormalGamma) or not isinstance(g2, NormalGamma):
        return None
    return nn.param, (g1.param, g2.param)


def _gamma_hypers(mcmc, name):
    dist = mcmc.model.get(name)
    if not isinstance(dist, Gamma) or not isinstance(dist.shape, Identity) or not isinstance(dist.rate, Identity):
        return None
    a = _scalar(mcmc, dist.shape.form)
    b = _scalar(mcmc, dist.rate.form)
    if a is None or b is None:
        return None
    return a, b


def _match_smoother(mcmc) -> Optional[Callable]:
    """y ~ N(b, (tau D)^-1); b ~ N(mu0, (lam P0)^-1); Gamma scales; D a positive
    diagonal, P0 any structured matrix. Runs the spectral engine for p <= 8192
    (p <= 1024 when P0 is tridiagonal) and the Thomas-scan engine for a
    tridiagonal P0 beyond that; a box-truncated latent prior needs a tridiagonal
    P0 and always takes the Thomas-scan engine's red-black sweep."""
    trip = _conjugate_triplet(mcmc)
    if trip is None:
        return None
    latent, _ = trip
    y_dist = None
    for key, dist in mcmc.model.items():
        if key != latent and isinstance(dist, Normal) and _identity_mean_name(dist) == latent:
            y_dist = dist
    b_dist = mcmc.model.get(latent)
    if y_dist is None or not isinstance(b_dist, Normal) or y_dist.truncated:
        return None
    truncated = b_dist.truncated
    if truncated and getattr(b_dist, "n_active", None) is not None:
        return None
    sp_y = _scaled_precision(y_dist)
    sp_b = _scaled_precision(b_dist)
    if sp_y is None or sp_b is None:
        return None
    ptau = mcmc.data.get(sp_y[0])
    plam = mcmc.data.get(sp_b[0])
    if not isinstance(ptau, st.Diagonal) or not bool(to_host(torch.all(ptau.diag_ > 0.0))):
        return None
    from openmcmc_tpu_torch.fused.spectral import MAX_P_SMOOTHER, MAX_P_SMOOTHER_STREAM, run_spectral_smoother

    if not isinstance(plam, st.STRUCTURED_TYPES):
        return None
    tridiag = isinstance(plam, st.Banded) and plam.bw == 1
    spectral = st.dim(plam) <= (MAX_P_SMOOTHER if tridiag else MAX_P_SMOOTHER_STREAM)
    if truncated:
        if not tridiag:
            return None  # the red-black sweep is written for two colours (bw = 1)
        spectral = False
    if not spectral and not tridiag:
        return None
    mu = _column(mcmc.data.get(_identity_mean_name(b_dist)))
    y = _column(mcmc.data.get(y_dist.response))
    if mu is None or y is None:
        return None
    tau_name, lam_name = sp_y[1], sp_b[1]
    # only the matched distributions: an extra term would be silently ignored
    if set(mcmc.model.keys()) != {y_dist.response, latent, tau_name, lam_name}:
        return None
    hyp_tau = _gamma_hypers(mcmc, tau_name)
    hyp_lam = _gamma_hypers(mcmc, lam_name)
    tau0 = _initial_scalar(mcmc, tau_name)
    lam0 = _initial_scalar(mcmc, lam_name)
    if None in (hyp_tau, hyp_lam, tau0, lam0):
        return None

    def package(out):
        store = {
            latent: out["b"][..., None],
            lam_name: out["lam"][..., None, None],
            tau_name: out["tau"][..., None, None],
        }
        return store, out["log_post"], {latent: {}, lam_name: {}, tau_name: {}}

    def resume_init(resume):
        """The per-chain (lam, tau) warm start, the conjugate kernels' whole
        carry (the latent is redrawn from its full conditional first); a
        truncated latent is carried too, so its final draws join it."""
        if resume is None:
            return None, mcmc.n_burn
        init = dict(zip(("lam", "tau"), _final_rows(resume, lam_name, tau_name)))
        if truncated:
            init["b"] = resume.final_state[latent]
        return init, 0

    if spectral:
        # host preparation, once per match. log_post must match Model.log_p's
        # convention for log|P0|: the clamped structured Cholesky, which for an
        # intrinsic prior differs from sum log s; its sequential tridiagonal
        # recurrence runs on a host copy rather than as p tiny device launches
        (field,) = dataclasses.fields(plam)  # a structured matrix holds one tensor: one read
        plam_host = dataclasses.replace(plam, **{field.name: to_host(getattr(plam, field.name))})
        logdet_p0 = st.host_log_det(plam_host)
        plam_dense = st.to_dense(plam_host).numpy()
        noise_host = to_host(ptau.diag_).numpy()

        def run(seed, bit_source=None, resume=None):
            init, n_burn = resume_init(resume)
            out = run_spectral_smoother(
                seed, y, plam_dense, n_burn=n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
                a_lam=hyp_lam[0], b_lam=hyp_lam[1], a_tau=hyp_tau[0], b_tau=hyp_tau[1],
                lam0=lam0, tau0=tau0, noise_diag=noise_host, mu0=mu, logdet_p0=logdet_p0, init=init,
                n_thin=_kernel_thin(mcmc), device=mcmc.device, bit_source=bit_source,
            )
            return package(out)

        run.engine_name = "fused_smoother_spectral"
    else:
        from openmcmc_tpu_torch.fused.gmrf_smoother import run_fused_smoother

        p_lat = st.dim(plam)
        lower_v = upper_v = b_init_v = None
        if truncated:
            lo_t, hi_t = b_dist.domain_response_lower, b_dist.domain_response_upper
            lower_v = None if lo_t is None else np.broadcast_to(np.asarray(lo_t, np.float64), (p_lat,))
            upper_v = None if hi_t is None else np.broadcast_to(np.asarray(hi_t, np.float64), (p_lat,))
            b0 = mcmc.initial_chain_state.get(latent)
            b_init_v = None if b0 is None else b0.detach().cpu().numpy().astype(np.float64).reshape(-1)
            if b_init_v is not None and b_init_v.shape[0] != p_lat:
                return None  # per-chain initial latents are not representable

        def run(seed, bit_source=None, resume=None):
            init, n_burn = resume_init(resume)
            out = run_fused_smoother(
                seed, y, None, n_burn=n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
                a_lam=hyp_lam[0], b_lam=hyp_lam[1], a_tau=hyp_tau[0], b_tau=hyp_tau[1],
                lam0=lam0, tau0=tau0, P0_bands=plam.bands, noise_diag=ptau.diag_, mu0=mu,
                lower=lower_v, upper=upper_v, b_init=b_init_v, init=init, n_thin=_kernel_thin(mcmc),
                device=mcmc.device, bit_source=bit_source,
            )
            return package(out)

        run.engine_name = "fused_gmrf_smoother_truncated" if truncated else "fused_gmrf_smoother"
    run.supports_resume = True
    run.store_keys = frozenset({latent, lam_name, tau_name})
    return run


def _match_linreg(mcmc) -> Optional[Callable]:
    """y ~ N(X beta, (tau P)^-1); beta ~ N(mu, (lam Plam)^-1); Gamma scales; P
    and Plam Diagonal. Runs the unrolled-Cholesky engine for p <= 16 and the
    spectral engine for p <= 256. As in the JAX package, P's diagonal is not
    checked for positive entries, and the engines count all N observations."""
    trip = _conjugate_triplet(mcmc)
    if trip is None:
        return None
    latent, _ = trip
    b_dist = mcmc.model.get(latent)
    y_dist = None
    for key, dist in mcmc.model.items():
        if (key != latent and isinstance(dist, Normal) and type(dist.mean) is LinearCombination
                and list(dist.mean.form_dict) == [latent]):
            y_dist = dist
    if y_dist is None or not isinstance(b_dist, Normal) or y_dist.truncated or b_dist.truncated:
        return None
    if _identity_mean_name(b_dist) is None:
        return None
    sp_y = _scaled_precision(y_dist)
    sp_b = _scaled_precision(b_dist)
    if sp_y is None or sp_b is None:
        return None
    ptau = mcmc.data.get(sp_y[0])
    plam = mcmc.data.get(sp_b[0])
    if not isinstance(ptau, st.Diagonal) or not isinstance(plam, st.Diagonal):
        return None
    X = mcmc.data.get(y_dist.mean.form_dict[latent])
    y = _column(mcmc.data.get(y_dist.response))
    mu = _column(mcmc.data.get(_identity_mean_name(b_dist)))
    if X is None or y is None or mu is None or isinstance(X, st.STRUCTURED_TYPES):
        return None
    from openmcmc_tpu_torch.fused.linreg import MAX_P, run_fused_linreg
    from openmcmc_tpu_torch.fused.spectral import MAX_P as SPECTRAL_MAX_P, run_spectral_linreg

    p = X.shape[1]
    if p > SPECTRAL_MAX_P:
        return None
    tau_name, lam_name = sp_y[1], sp_b[1]
    # only the matched distributions: an extra term would be silently ignored
    if set(mcmc.model.keys()) != {y_dist.response, latent, tau_name, lam_name}:
        return None
    hyp_tau = _gamma_hypers(mcmc, tau_name)
    hyp_lam = _gamma_hypers(mcmc, lam_name)
    tau0 = _initial_scalar(mcmc, tau_name)
    lam0 = _initial_scalar(mcmc, lam_name)
    if None in (hyp_tau, hyp_lam, tau0, lam0):
        return None
    # p <= 16: the unrolled engine, whose sufficient statistics are float32
    # device matmuls; larger p: the spectral engine, prepared on the host in f64
    if p <= MAX_P:
        runner, engine_name = run_fused_linreg, "fused_linreg"
    else:
        runner, engine_name = run_spectral_linreg, "fused_linreg_spectral"

    def run(seed, bit_source=None, resume=None):
        init, n_burn = None, mcmc.n_burn
        if resume is not None:  # the kernels' whole carry is (lam, tau), as the smoother's
            init, n_burn = dict(zip(("lam", "tau"), _final_rows(resume, lam_name, tau_name))), 0
        out = runner(
            seed, X, y, n_burn=n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
            a_tau=hyp_tau[0], b_tau=hyp_tau[1], a_lam=hyp_lam[0], b_lam=hyp_lam[1], lam0=lam0, tau0=tau0,
            mu=mu, plam_diag=plam.diag_, ptau_diag=ptau.diag_, init=init, n_thin=_kernel_thin(mcmc),
            device=mcmc.device, bit_source=bit_source,
        )
        store = {
            latent: out["beta"][..., None],
            lam_name: out["lam"][..., None, None],
            tau_name: out["tau"][..., None, None],
        }
        return store, out["log_post"], {latent: {}, lam_name: {}, tau_name: {}}

    run.engine_name = engine_name
    run.supports_resume = True
    run.store_keys = frozenset({latent, lam_name, tau_name})
    return run


def _counts(mcmc, out, n_chains):
    """The accept and proposal counts of a Metropolis runner, over burn-in and
    sampling sweeps (the generic driver's counting window)."""
    n_prop = mcmc.n_burn + mcmc.n_iter * _kernel_thin(mcmc)
    return {"accept": out["accept_total"].to(torch.int32),
            "proposal": torch.full((n_chains,), n_prop, dtype=torch.int32, device=out["accept_total"].device)}


def _match_rw(mcmc) -> Optional[Callable]:
    """A single RandomWalk on a (vector) location h: y ~ N(h, diag(tau)^-1),
    h ~ N(mu, diag(lam)^-1), constant hyperparameters, p <= 32."""
    if len(mcmc.samplers) != 1:
        return None
    rw = mcmc.samplers[0]
    if not isinstance(rw, RandomWalk) or isinstance(rw, RandomWalkLoop) or rw.state_update_function is not None:
        return None
    step_arr = rw.step_size.double().numpy().reshape(-1)
    h = rw.param
    h_dist = mcmc.model.get(h)
    y_dist = None
    for key, dist in mcmc.model.items():
        if key != h and isinstance(dist, Normal) and _identity_mean_name(dist) == h:
            y_dist = dist
    if y_dist is None or not isinstance(h_dist, Normal) or y_dist.truncated or h_dist.truncated:
        return None
    # replicate columns of y are fine: the engine reduces y to per-dimension sums
    y = mcmc.data.get(y_dist.response)
    if y is None or isinstance(y, st.STRUCTURED_TYPES):
        return None
    from openmcmc_tpu_torch.fused.random_walk import MAX_P, run_fused_rw

    p = y.shape[0]
    if p > MAX_P or step_arr.size not in (1, p):
        return None
    step_vec = np.broadcast_to(step_arr, (p,))
    # only the matched distributions: an extra term would be silently ignored
    if set(mcmc.model.keys()) != {y_dist.response, h}:
        return None

    def precision_diag(dist):
        """The (p,) diagonal of an Identity-form constant diagonal precision, else None."""
        if not isinstance(dist.precision, Identity):
            return None
        value = mcmc.data.get(dist.precision.form)
        if value is None:
            return None
        try:
            arr = st.to_dense(st.as_structured(value)).detach().cpu().double().numpy()
        except TypeError:
            return None
        if arr.shape == (1, 1):
            return np.full((p,), float(arr[0, 0]))
        if arr.shape != (p, p) or np.any(arr != np.diag(np.diag(arr))):
            return None
        return np.diag(arr)

    tau = precision_diag(y_dist)
    lam = precision_diag(h_dist)
    mu_name = _identity_mean_name(h_dist)
    mu = None if mu_name is None else _column(mcmc.data.get(mu_name))
    h0 = _column(mcmc.initial_chain_state.get(h))
    if tau is None or lam is None or mu is None or h0 is None:
        return None
    if mu.size not in (1, p) or h0.size not in (1, p):
        return None  # replicated h columns need the generic driver
    mu = np.broadcast_to(mu.astype(np.float64), (p,))
    h0 = np.broadcast_to(h0.astype(np.float64), (p,))
    domain = None
    if rw.domain_limits is not None:
        dl = np.asarray(rw.domain_limits, np.float64).reshape(-1, 2)
        if dl.shape[0] not in (1, p):
            return None
        dl = np.broadcast_to(dl, (p, 2))
        domain = (dl[:, 0].copy(), dl[:, 1].copy())
        # the start must lie inside the proposal box, where the reverse density is defined
        if np.any(h0 <= domain[0]) or np.any(h0 >= domain[1]):
            return None

    def run(seed, bit_source=None):
        nc = mcmc.n_chains
        out = run_fused_rw(
            seed, y, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=nc, mu=mu, tau=tau, lam=lam, step=step_vec,
            h0=h0, adapt_step=rw.adapt_step, target_accept=rw.target_accept, adapt_rate=rw.adapt_rate,
            domain=domain, n_thin=_kernel_thin(mcmc), device=mcmc.device, bit_source=bit_source,
        )
        stats = {h: _counts(mcmc, out, nc)}
        if rw.adapt_step:
            # the engine stores log(scale * step[0]) and the generic nudge is one
            # scalar shared by all components, so the vector log_step is
            # log(step) + log(scale), in the step's at-least-2-D shape
            base = torch.log(rw.step_size).to(out["log_step"].device)
            scale_log = out["log_step"] - float(np.log(step_vec[0]))
            stats[h]["log_step"] = scale_log[:, None, None] + base[None, :, :]
        return {h: out["h"][..., None]}, out["log_post"], stats

    run.engine_name = "fused_random_walk"
    run.store_keys = frozenset({h})
    return run


def _match_mmala(mcmc) -> Optional[Callable]:
    """A single ManifoldMALA on beta: y ~ N(X beta, (tau P)^-1), beta ~ N(mu0,
    (lam Plam)^-1), P and Plam Diagonal, tau and lam constant data (the metric is
    then constant). Runs the Cholesky engine for p <= 16 and the spectral one for
    p <= 256."""
    if len(mcmc.samplers) != 1:
        return None
    mm = mcmc.samplers[0]
    if not isinstance(mm, ManifoldMALA) or mm.active_count is not None or mm.step_size.numel() != 1:
        return None
    latent = mm.param
    b_dist = mcmc.model.get(latent)
    y_dist = None
    for key, dist in mcmc.model.items():
        if (key != latent and isinstance(dist, Normal) and type(dist.mean) is LinearCombination
                and list(dist.mean.form_dict) == [latent]):
            y_dist = dist
    if y_dist is None or not isinstance(b_dist, Normal) or y_dist.truncated or b_dist.truncated:
        return None
    if _identity_mean_name(b_dist) is None:
        return None
    sp_y = _scaled_precision(y_dist)
    sp_b = _scaled_precision(b_dist)
    if sp_y is None or sp_b is None:
        return None
    ptau = mcmc.data.get(sp_y[0])
    plam = mcmc.data.get(sp_b[0])
    if not isinstance(ptau, st.Diagonal) or not isinstance(plam, st.Diagonal):
        return None
    tau = _scalar(mcmc, sp_y[1])
    lam = _scalar(mcmc, sp_b[1])  # constants: in the data, not the chain state
    X = mcmc.data.get(y_dist.mean.form_dict[latent])
    y = _column(mcmc.data.get(y_dist.response))
    mu0 = _column(mcmc.data.get(_identity_mean_name(b_dist)))
    if any(v is None for v in (tau, lam, X, y, mu0)) or isinstance(X, st.STRUCTURED_TYPES):
        return None
    # only the matched distributions: an extra term would be silently ignored
    if set(mcmc.model.keys()) != {y_dist.response, latent}:
        return None
    from openmcmc_tpu_torch.fused.mmala import MAX_P, run_fused_mmala
    from openmcmc_tpu_torch.fused.spectral import MAX_P as SPECTRAL_MAX_P, run_spectral_mmala

    p = X.shape[1]
    if p > SPECTRAL_MAX_P:
        return None
    beta0 = mcmc.initial_chain_state.get(latent)
    if beta0 is not None:
        beta0 = _column(beta0)
        if beta0 is None:
            return None  # replicated beta columns need the generic driver
    if p <= MAX_P:
        runner, engine_name = run_fused_mmala, "fused_mmala"
    else:
        runner, engine_name = run_spectral_mmala, "fused_mmala_spectral"
    # host preparation in float64 from host copies, once per match
    X_host = X.detach().cpu().numpy()
    ptau_host, plam_host = ptau.diag_.detach().cpu().numpy(), plam.diag_.detach().cpu().numpy()

    def run(seed, bit_source=None):
        nc = mcmc.n_chains
        extra = {}
        if mm.adapt_step:
            extra = dict(adapt_step=True, target_accept=mm.target_accept, adapt_rate=mm.adapt_rate)
        out = runner(
            seed, X_host, y, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=nc, tau=tau, lam=lam,
            step=float(mm.step_size.reshape(())), ptau_diag=ptau_host, plam_diag=plam_host, mu0=mu0, beta0=beta0,
            n_thin=_kernel_thin(mcmc), device=mcmc.device, bit_source=bit_source, **extra,
        )
        stats = {latent: _counts(mcmc, out, nc)}
        if mm.adapt_step:
            # the generic init_stats carries log_step in the step's (1, 1) shape
            stats[latent]["log_step"] = out["log_step"].reshape(nc, 1, 1)
        return {latent: out["beta"][..., None]}, out["log_post"], stats

    run.engine_name = engine_name
    run.store_keys = frozenset({latent})
    return run


# The JAX engine's streamed reversible-jump draws: (n_iter, rows, chains rounded
# up to its 1024-lane block) float32, capped at 4 GB (openmcmc_tpu/fused/rj.py:
# BLOCK_B, OUT_ROWS; dispatch.py:812-819). The port stores them unpadded, but caps
# them by the same formula so that both packages pick the same engine.
_JAX_RJ_BLOCK_B, _JAX_RJ_OUT_ROWS = 1024, 8
RJ_STREAM_CAP_BYTES = 4 << 30


def _jax_rj_stream_bytes(n_chains: int, n_iter: int, n_thin: int, lik: bool, n_max: int) -> int:
    """Bytes of the JAX engine's streamed-draw buffer for these sizes."""
    padded = n_chains + (-n_chains) % _JAX_RJ_BLOCK_B
    return 4 * n_iter * n_thin * (_JAX_RJ_OUT_ROWS + int(lik) + 3 * n_max) * padded


def _match_rj(mcmc) -> Optional[Callable]:
    """The reversible-jump knot-basis regression:

        count ~ Poisson(rho), theta_j ~ U(lo, hi), omega_j ~ Gamma(a, b),
        beta ~ N(mu_b, (tau_b I)^-1)  (padded to n_max, n_active = count),

    with a Null likelihood (prior recovery) and the sweep [ManifoldMALA(beta),
    RandomWalkLoop(theta), RandomWalkLoop(omega), ReversibleJump(count, matched
    transitions on beta)], or with y ~ N(B beta, (tau I)^-1) and a fifth sampler
    NormalGamma(tau). The basis hooks must be bound methods of one
    :class:`openmcmc_tpu_torch.basis.GaussianKernelBasis`: that is what tells the
    matcher the basis is normpdf(X; theta, omega), which the kernel computes
    itself. Every check of the JAX package's ``_match_rj``."""
    from openmcmc_tpu_torch.basis import GaussianKernelBasis
    from openmcmc_tpu_torch.distributions.location_scale import NullDistribution
    from openmcmc_tpu_torch.distributions.univariate import Poisson, Uniform
    from openmcmc_tpu_torch.samplers.reversible_jump import ReversibleJump

    if len(mcmc.samplers) not in (4, 5):
        return None
    lik = len(mcmc.samplers) == 5
    if lik and not isinstance(mcmc.samplers[4], NormalGamma):
        return None
    mala, rw_th, rw_om, rj = mcmc.samplers[:4]
    if not isinstance(mala, ManifoldMALA) or not isinstance(rj, ReversibleJump):
        return None
    if not (isinstance(rw_th, RandomWalkLoop) and isinstance(rw_om, RandomWalkLoop)):
        return None
    if any(s.adapt_step for s in (mala, rw_th, rw_om)):
        return None
    if any(s.step_size.numel() != 1 for s in (mala, rw_th, rw_om)):
        return None
    count, beta, theta, omega = rj.param, mala.param, rw_th.param, rw_om.param
    if rj.associated_params != [theta, omega] or rj.birth_probability != 0.5:
        return None
    if {mala.active_count, rw_th.active_count, rw_om.active_count} != {count}:
        return None

    def bound_to(fn, method):
        return getattr(fn, "__func__", None) is method and isinstance(getattr(fn, "__self__", None), GaussianKernelBasis)

    if not bound_to(rj.state_birth_function, GaussianKernelBasis.birth):
        return None
    g = rj.state_birth_function.__self__
    if not bound_to(rj.state_death_function, GaussianKernelBasis.death):
        return None
    for rw in (rw_th, rw_om):
        if not (bound_to(rw.state_update_function, GaussianKernelBasis.move)
                and bound_to(rw.vector_state_update_function, GaussianKernelBasis.move_vec)
                and rw.state_update_function.__self__ is g and rw.vector_state_update_function.__self__ is g):
            return None
    if (g.theta, g.omega, g.count) != (theta, omega, count):
        return None
    mp = rj.matching_params
    if mp is None or mp.get("variable") != beta or mp.get("matrix") != g.matrix:
        return None
    if mp.get("limits") is None or mp.get("scale") is None:
        return None

    # the model: the likelihood, the four priors and, with a likelihood, tau's
    y_name = None
    for key, dist in mcmc.model.items():
        if lik:
            if key != beta and isinstance(dist, Normal):
                y_name = key
        elif isinstance(dist, NullDistribution):
            y_name = key
    if y_name is None:
        return None
    tau_name, hyp_tau, tau0, y_data = None, None, None, None
    expected = {y_name, beta, theta, omega, count}
    if lik:
        tau_name = mcmc.samplers[4].param
        expected.add(tau_name)
    if set(mcmc.model.keys()) != expected:
        return None
    y_dist = mcmc.model[y_name]
    if not (isinstance(y_dist.mean, LinearCombination) and list(y_dist.mean.form_dict) == [beta]
            and y_dist.mean.form_dict[beta] == g.matrix):
        return None
    if lik:
        # y ~ N(B beta, (tau P)^-1) with P the identity (the kernel's residual
        # quadratic is unweighted) and a conjugate Gamma prior on tau
        if y_dist.truncated or y_dist.n_active is not None:
            return None
        sp_y = _scaled_precision(y_dist)
        if sp_y is None or sp_y[1] != tau_name:
            return None
        pen = mcmc.data.get(sp_y[0])
        if not isinstance(pen, st.Diagonal) or not bool(to_host(torch.all(pen.diag_ == 1.0))):
            return None
        hyp_tau = _gamma_hypers(mcmc, tau_name)
        tau0 = _initial_scalar(mcmc, tau_name)
        y_data = _column(mcmc.data.get(y_name))
        if hyp_tau is None or tau0 is None or y_data is None:
            return None  # replicate response columns need the generic driver
    k_dist = mcmc.model[count]
    if not (isinstance(k_dist, Poisson) and isinstance(k_dist.rate, Identity)):
        return None
    rho = _scalar(mcmc, k_dist.rate.form)
    th_dist = mcmc.model[theta]
    if not isinstance(th_dist, Uniform) or th_dist.n_active != count:
        return None
    if len(th_dist.domain_response_lower) != 1 or len(th_dist.domain_response_upper) != 1:
        return None
    th_lims = (th_dist.domain_response_lower[0], th_dist.domain_response_upper[0])
    # theta's random walk must be truncated at the prior's domain
    if rw_th.domain_limits is None or tuple(np.asarray(rw_th.domain_limits).reshape(-1)) != th_lims:
        return None
    if rw_om.domain_limits is None or np.asarray(rw_om.domain_limits).size != 2:
        return None
    om_lims = tuple(float(v) for v in np.asarray(rw_om.domain_limits).reshape(-1))
    om_dist = mcmc.model[omega]
    if not isinstance(om_dist, Gamma) or om_dist.n_active != count:
        return None
    hyp_om = _gamma_hypers(mcmc, omega)
    b_dist = mcmc.model[beta]
    if not isinstance(b_dist, Normal) or b_dist.truncated or b_dist.n_active != count:
        return None
    # a single-component mixture mean and precision: the constants mu_b, tau_b
    if not (isinstance(b_dist.mean, MixtureParameterVector) and isinstance(b_dist.precision, MixtureParameterMatrix)
            and b_dist.mean.allocation == b_dist.precision.allocation):
        return None
    alloc = mcmc.data.get(b_dist.mean.allocation)
    if alloc is None or isinstance(alloc, st.STRUCTURED_TYPES) or bool(to_host(torch.any(alloc != 0))):
        return None
    mu_b = _scalar(mcmc, b_dist.mean.param)
    tau_b = _scalar(mcmc, b_dist.precision.param)
    X = mcmc.data.get(g.x)
    init = mcmc.initial_chain_state
    if any(v is None for v in (rho, hyp_om, mu_b, tau_b, X)) or rho <= 0.0:
        return None
    if any(init.get(name) is None for name in (beta, theta, omega, count)):
        return None
    from openmcmc_tpu_torch.fused.rj import MAX_N_MAX, run_fused_rj

    n_max = int(rj.n_max)
    if n_max > MAX_N_MAX or init[theta].numel() != n_max:
        return None
    # the kernel stores the count and log_post, and the padded beta/theta/omega
    # draws when asked; B is derived state it never stores
    storable = {count, beta, theta, omega} | ({tau_name} if lik else set())
    if not set(mcmc.store_names) <= storable:
        return None
    # a fitted value read from B needs the generic driver: the data's B is the
    # stale initial basis
    if mcmc.model.response is not None:
        for resp, pname in mcmc.model.response.items():
            if g.matrix in getattr(mcmc.model[resp], pname).get_param_list():
                return None
    stream = bool(set(mcmc.store_names) & {beta, theta, omega})
    if stream and _jax_rj_stream_bytes(mcmc.n_chains, mcmc.n_iter, mcmc.n_thin, lik, n_max) > RJ_STREAM_CAP_BYTES:
        return None
    # the host copies the runner uploads every fit, each read from the card once, at the match
    host = {name: to_host(init[name]).numpy().astype(np.float64) for name in (beta, theta, omega)}
    k0 = float(to_host(init[count]).reshape(()))
    X_host = to_host(X).numpy().astype(np.float64).reshape(-1)
    step = {s.param: float(s.step_size.reshape(())) for s in (mala, rw_th, rw_om)}

    def run(seed, bit_source=None, resume=None):
        nc = mcmc.n_chains
        extra = {}
        if lik:
            extra = dict(y=np.asarray(y_data, np.float64).reshape(-1), a_tau=hyp_tau[0], b_tau=hyp_tau[1], tau0=tau0)
        warm, n_burn, prop0 = None, mcmc.n_burn, 0
        if resume is not None:
            fs, rstats = resume.final_state, resume.stats
            warm = {"beta": fs[beta].reshape(nc, n_max), "theta": fs[theta].reshape(nc, n_max),
                    "omega": fs[omega].reshape(nc, n_max), "k": fs[count].reshape(-1),
                    # the kernel's counter order: acc_mmala, acc_theta, acc_omega, acc_rj, prop_theta, prop_omega
                    "counters": torch.stack([rstats[name][key].reshape(-1).to(torch.float32) for name, key in (
                        (beta, "accept"), (theta, "accept"), (omega, "accept"), (count, "accept"),
                        (theta, "proposal"), (omega, "proposal"))])}
            if lik:
                warm["tau"] = fs[tau_name].reshape(-1)
            prop0 = rstats[count]["proposal"].reshape(-1).to(device=mcmc.device, dtype=torch.int32)
            n_burn = 0
        out = run_fused_rj(
            seed, X_host, n_burn=n_burn, n_iter=mcmc.n_iter, n_chains=nc, n_max=n_max, beta0=host[beta],
            theta0=host[theta], omega0=host[omega], k0=k0, rho=rho, mu_beta=mu_b, tau_beta=tau_b, a_omega=hyp_om[0],
            b_omega=hyp_om[1], theta_limits=th_lims, omega_rw_limits=om_lims,
            match_limits=(float(mp["limits"][0]), float(mp["limits"][1])), match_scale=float(mp["scale"]),
            step_mmala=step[beta], step_theta=step[theta], step_omega=step[omega], stream_params=stream,
            init=warm, n_thin=_kernel_thin(mcmc), device=mcmc.device, bit_source=bit_source, **extra,
        )
        store = {count: out["n_basis"][..., None, None].to(torch.int32)}
        if lik:
            store[tau_name] = out["tau"][..., None, None]
        if stream:
            # the state's shapes: beta (n_max, 1), theta and omega (1, n_max)
            store[beta] = out["beta"][..., None]
            store[theta] = out["theta"][:, :, None, :]
            store[omega] = out["omega"][:, :, None, :]
        dev = out["log_post"].device
        n_prop = prop0 + torch.full((nc,), n_burn + mcmc.n_iter * _kernel_thin(mcmc), dtype=torch.int32, device=dev)
        stats = {
            beta: {"accept": out["accept_mmala"].to(torch.int32), "proposal": n_prop},
            theta: {"accept": out["accept_theta"].to(torch.int32), "proposal": out["proposal_theta"].to(torch.int32)},
            omega: {"accept": out["accept_omega"].to(torch.int32), "proposal": out["proposal_omega"].to(torch.int32)},
            count: {"accept": out["accept_rj"].to(torch.int32), "proposal": n_prop.clone()},
        }
        if lik:
            stats[tau_name] = {}  # a conjugate sampler carries no statistics
        return store, out["log_post"], stats

    run.engine_name = "fused_rj"
    run.supports_resume = True
    run.store_keys = frozenset({count} | ({tau_name} if lik else set()) | ({beta, theta, omega} if stream else set()))

    def resume_ok(resume):
        """A warm start needs the padded parameters' final values: present after
        a generic run or a streamed fused run, absent after a count-only one."""
        needed = (beta, theta, omega, count) + ((tau_name,) if lik else ())
        return all(name in resume.final_state for name in needed) and all(
            name in resume.stats and "accept" in resume.stats[name] for name in (beta, theta, omega, count))

    run.resume_ok = resume_ok
    return run


# The JAX engine's padded Z buffer, which its matcher caps at 4 GB
# (openmcmc_tpu/fused/mixture.py: RESIDENT_N, TILE_N, UNROLL, PAD, pad_unit,
# _block_b). The port stores Z unpadded, but caps it by the same formula so that
# both packages pick the same engine for the same run.
_JAX_RESIDENT_N, _JAX_TILE_N, _JAX_UNROLL, _JAX_PAD = 2048, 1024, 2, 8
Z_CAP_BYTES = 4 << 30


def _jax_z_buffer_bytes(n: int, k_comp: int, n_chains: int, n_iter: int) -> int:
    """Bytes of the JAX engine's (n_iter, n_pad, chains rounded to its lane
    block) float32 Z buffer."""
    stream = n > _JAX_RESIDENT_N
    n_pad = n + (-n) % (_JAX_UNROLL * _JAX_TILE_N if stream else _JAX_PAD)
    live = (k_comp + 5 + 2) * (_JAX_TILE_N if stream else n_pad) * 4
    block = next((b for b in (2048, 1024, 512, 256) if live * b <= (24 << 20)), 128)
    return 4 * n_iter * n_pad * (n_chains + (-n_chains) % block)


def _host_array(value) -> np.ndarray:
    return value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def _match_mixture(mcmc) -> Optional[Callable]:
    """The K-component Gaussian mixture:

        y_i ~ N(mu_{Z_i}, 1/lam_{Z_i}),  Z_i ~ Categorical(w_i.),
        mu ~ N(mu0, diag(p0)^-1),  lam_k ~ Gamma(a0_k, b0_k),

    swept as [MixtureAllocation(Z), RandomWalkLoop(mu) or NormalNormal(mu),
    NormalGamma(lam)]. Requires constant weights and hyperparameters, K <= 32,
    n <= 2^20, every a0_k >= 1 (the kernel's elementwise Gamma draw), initial
    means strictly inside a random walk's box, and store_names within {mu, lam,
    Z}; storing Z (the driver's default) is capped at the JAX engine's 4 GB.
    Replicate response columns share each point's allocation."""
    if len(mcmc.samplers) != 3:
        return None
    alloc, rwl, ng = mcmc.samplers
    conjugate = isinstance(rwl, NormalNormal)
    if (not isinstance(alloc, MixtureAllocation) or not (conjugate or isinstance(rwl, RandomWalkLoop))
            or not isinstance(ng, NormalGamma)):
        return None
    if not conjugate:
        if rwl.adapt_step or rwl.state_update_function is not None or rwl.active_count is not None:
            return None
        if rwl.step_size.numel() != 1:
            return None
    z_name, mu_name, lam_name, y_name = alloc.param, rwl.param, ng.param, alloc.response_param
    if set(mcmc.model.keys()) != {y_name, z_name, mu_name, lam_name}:
        return None
    y_dist = mcmc.model[y_name]
    if not isinstance(y_dist, Normal) or y_dist.truncated:
        return None
    if not (isinstance(y_dist.mean, MixtureParameterVector) and isinstance(y_dist.precision, MixtureParameterMatrix)
            and y_dist.mean.param == mu_name and y_dist.precision.param == lam_name
            and y_dist.mean.allocation == z_name and y_dist.precision.allocation == z_name):
        return None
    z_dist = mcmc.model[z_name]
    if not isinstance(z_dist, Categorical) or not isinstance(z_dist.prob, Identity):
        return None
    prior, y = mcmc.data.get(z_dist.prob.form), mcmc.data.get(y_name)
    if prior is None or y is None or isinstance(prior, st.STRUCTURED_TYPES) or isinstance(y, st.STRUCTURED_TYPES):
        return None
    prior, yv = _host_array(prior), _host_array(y)
    if yv.ndim == 1:
        yv = yv[:, None]
    if yv.ndim != 2 or prior.ndim != 2:
        return None
    from openmcmc_tpu_torch.fused.mixture import MAX_K, MAX_N, run_fused_mixture

    n, k_comp = prior.shape
    # replicate columns collapse to per-point count, sum and sum of squares
    if yv.shape[0] != n or k_comp > MAX_K or n > MAX_N:
        return None
    if np.any(prior <= 0.0):
        return None

    mu_dist = mcmc.model[mu_name]
    if not isinstance(mu_dist, Normal) or mu_dist.truncated:
        return None
    if not isinstance(mu_dist.mean, Identity) or not isinstance(mu_dist.precision, Identity):
        return None
    mu0, p0_val = mcmc.data.get(mu_dist.mean.form), mcmc.data.get(mu_dist.precision.form)
    if mu0 is None or p0_val is None:
        return None
    if isinstance(p0_val, st.Diagonal):
        p0 = _host_array(p0_val.diag_)
    elif isinstance(p0_val, st.STRUCTURED_TYPES):
        arr = _host_array(st.to_dense(p0_val))
        if np.any(arr != np.diag(np.diag(arr))):
            return None
        p0 = np.diag(arr)
    else:
        p0 = _host_array(p0_val).reshape(-1)
    p0 = np.broadcast_to(np.asarray(p0, np.float64).reshape(-1), (k_comp,))
    if np.any(p0 <= 0.0):
        return None

    lam_dist = mcmc.model[lam_name]
    if (not isinstance(lam_dist, Gamma) or not isinstance(lam_dist.shape, Identity)
            or not isinstance(lam_dist.rate, Identity)):
        return None
    a0, b0 = mcmc.data.get(lam_dist.shape.form), mcmc.data.get(lam_dist.rate.form)
    if a0 is None or b0 is None:
        return None
    a0 = np.broadcast_to(_host_array(a0).astype(np.float64).reshape(-1), (k_comp,))
    b0 = np.broadcast_to(_host_array(b0).astype(np.float64).reshape(-1), (k_comp,))
    if np.min(a0) < 1.0:  # the elementwise Marsaglia-Tsang draw needs a* = a0 + count/2 >= 1
        return None

    mu_i, lam_i = mcmc.initial_chain_state.get(mu_name), mcmc.initial_chain_state.get(lam_name)
    if mu_i is None or lam_i is None:
        return None
    mu_i = _host_array(mu_i).astype(np.float64)
    if mu_i.ndim == 2 and mu_i.shape[1] != 1:
        return None  # RandomWalkLoop must scan exactly one replicate column
    mu_i = mu_i.reshape(-1)
    lam_i = _host_array(lam_i).astype(np.float64).reshape(-1)
    if mu_i.shape[0] != k_comp or lam_i.shape[0] != k_comp:
        return None

    domain = None
    if not conjugate and rwl.domain_limits is not None:
        dl = np.asarray(rwl.domain_limits, np.float64)
        if dl.shape != (k_comp, 2):
            return None
        domain = (dl[:, 0], dl[:, 1])
        if np.any(mu_i <= domain[0]) or np.any(mu_i >= domain[1]):
            return None  # the means must start strictly inside the proposal box
    store_z = z_name in mcmc.store_names
    if not set(mcmc.store_names) <= {mu_name, lam_name, z_name}:
        return None
    if store_z and _jax_z_buffer_bytes(n, k_comp, mcmc.n_chains, mcmc.n_iter) > Z_CAP_BYTES:
        return None
    mu0v = np.broadcast_to(_host_array(mu0).astype(np.float64).reshape(-1), (k_comp,))
    step = 0.2 if conjugate else float(rwl.step_size.reshape(()))

    def run(seed, bit_source=None):
        nc = mcmc.n_chains
        out = run_fused_mixture(
            seed, yv, prior, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=nc, mu0=mu0v, p0=p0, a0=a0, b0=b0,
            mu_init=mu_i, lam_init=lam_i, step=step, domain=domain, conjugate_means=conjugate, store_z=store_z,
            n_thin=_kernel_thin(mcmc), device=mcmc.device, bit_source=bit_source,
        )
        store = {mu_name: out["means"][..., None], lam_name: out["lams"][..., None]}
        if store_z:
            store[z_name] = out["z"][..., None]  # (chains, n_iter, n, 1) int32
        # conjugate means carry no Metropolis counters, as in the generic driver
        stats = {z_name: {}, mu_name: {} if conjugate else _counts(mcmc, out, nc), lam_name: {}}
        return store, out["log_post"], stats

    run.engine_name = "fused_mixture_conjugate" if conjugate else "fused_mixture"
    run.store_keys = frozenset({mu_name, lam_name} | ({z_name} if store_z else set()))
    return run
