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
for p <= 256 (``fused_mmala_spectral``, kernel K9). The Metropolis runners return
the JAX package's statistics: accept and proposal counts over burn-in and
sampling, and the adapted log_step. The mixture and reversible-jump matchers,
resume and mesh sharding are not ported (ROADMAP.md queue 1: mixture,
reversible jump, operations, parallel).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.distributions.univariate import Gamma
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.parameters import Identity, LinearCombination, ScaledMatrix
from openmcmc_tpu_torch.samplers.conjugate import NormalGamma, NormalNormal
from openmcmc_tpu_torch.samplers.metropolis import ManifoldMALA, RandomWalk, RandomWalkLoop


def _scalar(mcmc, name) -> Optional[float]:
    value = mcmc.data.get(name)
    if value is None or isinstance(value, st.STRUCTURED_TYPES):
        return None
    if value.numel() != 1:
        return None
    return float(value.reshape(()))


def _column(value) -> Optional[np.ndarray]:
    """The single replicate column of a state entry as a 1-D host array, or None
    when the entry has several replicate columns (the single-column engines
    cannot represent them)."""
    if value is None or isinstance(value, st.STRUCTURED_TYPES):
        return None
    arr = value.detach().cpu().numpy()
    if arr.ndim <= 1:
        return arr.reshape(-1)
    if arr.ndim == 2 and arr.shape[1] == 1:
        return arr[:, 0]
    return None


def _initial_scalar(mcmc, name) -> Optional[float]:
    value = mcmc.initial_chain_state.get(name)
    if value is None or value.numel() != 1:
        return None
    return float(value.reshape(()))


def _identity_mean_name(dist) -> Optional[str]:
    if isinstance(dist.mean, Identity):
        return dist.mean.form
    return None


def _scaled_precision(dist):
    """(matrix_name, scale_name) for a ScaledMatrix precision, else None."""
    if isinstance(dist.precision, ScaledMatrix):
        return dist.precision.matrix, dist.precision.scalar
    return None


def match_fused_engine(mcmc) -> Optional[Callable]:
    """Return a callable ``runner(seed, bit_source=None)`` running the MCMC as a
    fused engine, or None.

    Thinning: the matcher sees a shallow clone whose ``n_burn`` is the SWEEP count
    (n_burn * n_thin) and whose ``_kernel_thin`` the engines apply in-kernel."""
    matched = mcmc
    if mcmc.n_thin != 1:
        matched = copy.copy(mcmc)
        matched.n_burn = mcmc.n_burn * mcmc.n_thin
        matched.n_thin = 1
        matched._kernel_thin = mcmc.n_thin
    for matcher in (_match_smoother, _match_linreg, _match_rw, _match_mmala):
        runner = matcher(matched)
        if runner is not None:
            if mcmc.model.response is not None and not _fitted_ok(mcmc, runner):
                return None
            return runner
    return None


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
    if not isinstance(ptau, st.Diagonal) or not bool(torch.all(ptau.diag_ > 0.0)):
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

    if spectral:
        # host preparation, once per match. log_post must match Model.log_p's
        # convention for log|P0|: the clamped structured Cholesky, which for an
        # intrinsic prior differs from sum log s; its sequential tridiagonal
        # recurrence runs on a host copy rather than as p tiny device launches
        logdet_p0 = st.host_log_det(plam)
        plam_dense = st.to_dense(st.to(plam, "cpu")).numpy()
        noise_host = ptau.diag_.detach().cpu().numpy()

        def run(seed, bit_source=None):
            out = run_spectral_smoother(
                seed, y, plam_dense, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
                a_lam=hyp_lam[0], b_lam=hyp_lam[1], a_tau=hyp_tau[0], b_tau=hyp_tau[1],
                lam0=lam0, tau0=tau0, noise_diag=noise_host, mu0=mu, logdet_p0=logdet_p0,
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

        def run(seed, bit_source=None):
            out = run_fused_smoother(
                seed, y, None, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
                a_lam=hyp_lam[0], b_lam=hyp_lam[1], a_tau=hyp_tau[0], b_tau=hyp_tau[1],
                lam0=lam0, tau0=tau0, P0_bands=plam.bands, noise_diag=ptau.diag_, mu0=mu,
                lower=lower_v, upper=upper_v, b_init=b_init_v, n_thin=_kernel_thin(mcmc),
                device=mcmc.device, bit_source=bit_source,
            )
            return package(out)

        run.engine_name = "fused_gmrf_smoother_truncated" if truncated else "fused_gmrf_smoother"
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

    def run(seed, bit_source=None):
        out = runner(
            seed, X, y, n_burn=mcmc.n_burn, n_iter=mcmc.n_iter, n_chains=mcmc.n_chains,
            a_tau=hyp_tau[0], b_tau=hyp_tau[1], a_lam=hyp_lam[0], b_lam=hyp_lam[1], lam0=lam0, tau0=tau0,
            mu=mu, plam_diag=plam.diag_, ptau_diag=ptau.diag_, n_thin=_kernel_thin(mcmc), device=mcmc.device,
            bit_source=bit_source,
        )
        store = {
            latent: out["beta"][..., None],
            lam_name: out["lam"][..., None, None],
            tau_name: out["tau"][..., None, None],
        }
        return store, out["log_post"], {latent: {}, lam_name: {}, tau_name: {}}

    run.engine_name = engine_name
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
