"""The reversible-jump knot-basis regression, built in the program as a user
writes it: the reference's test_reversible_jump.py fixture with its Null
response replaced by data,

    y ~ N(B beta, (tau_y I)^-1),  B[:, j] = normpdf(X; theta_j, omega_j),
    k ~ Poisson(rho) on 1..n_max, and for j < k: theta_j ~ U(lo, hi),
    omega_j ~ Gamma(a_omega, b_omega), beta_j ~ N(mu_beta, 1 / tau_beta),
    tau_y ~ Gamma(a_tau, b_tau)

Data (the fixture's law): X n_data sorted uniform draws on [lo, hi]; y from
k_true knots at uniform locations, widths omega_true and coefficients
beta_true_sd N(0, 1), plus N(0, noise_sd^2); and the k0 starting knots,
uniform on [lo, hi], widths 1 and coefficients 1, tau_y at tau0. Samplers:
ManifoldMALA on beta, truncated random walks on theta and omega, ReversibleJump
on k with prediction-matched birth and death, NormalGamma on tau_y; k, beta,
theta, omega and tau_y stored.
"""

from __future__ import annotations

import numpy as np
import torch


def make_data(cfg: dict, generator: torch.Generator, device) -> dict:
    """X, y and the starting knots from the seed's generator, on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = cfg["theta_limits"]
    n, k_true = cfg["n_data"], cfg["k_true"]
    X = lo + (hi - lo) * torch.sort(torch.rand(n, generator=generator, **f32)).values
    th_true = lo + (hi - lo) * torch.rand(k_true, generator=generator, **f32)
    beta_true = cfg["beta_true_sd"] * torch.randn(k_true, generator=generator, **f32)
    om = cfg["omega_true"]
    z = (X[:, None] - th_true[None, :]) / om
    B = torch.exp(-0.5 * z * z) / (om * float(np.sqrt(2.0 * np.pi)))
    y = B @ beta_true + cfg["noise_sd"] * torch.randn(n, generator=generator, **f32)
    theta0 = lo + (hi - lo) * torch.rand(cfg["k0"], generator=generator, **f32)
    return {"X": X, "y": y, "theta0": theta0}


def build(cfg: dict, data: dict, device):
    """The program's MCMC for this configuration, as a user writes it."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.basis import GaussianKernelBasis
    from openmcmc_tpu_torch.distributions import Gamma, Normal, Poisson, Uniform
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import (LinearCombination, MixtureParameterMatrix, MixtureParameterVector,
                                               ScaledMatrix)
    from openmcmc_tpu_torch.samplers import ManifoldMALA, NormalGamma, RandomWalkLoop, ReversibleJump

    p, k0, n = cfg["n_max"], cfg["k0"], cfg["n_data"]
    lo, hi = cfg["theta_limits"]
    g = GaussianKernelBasis()
    X = data["X"].cpu().double().numpy()[:, None]
    theta = np.zeros((1, p)); theta[0, :k0] = data["theta0"].cpu().double().numpy()
    omega = np.zeros((1, p)); omega[0, :k0] = 1.0
    beta = np.zeros((p, 1)); beta[:k0] = 1.0
    state = {"X": X, "y": data["y"].cpu().double().numpy()[:, None], "n_basis": np.array([[k0]], dtype=np.int32),
             "theta": theta, "omega": omega, "beta": beta, "alloc_beta": np.zeros((p, 1), dtype=np.int32),
             "mu_beta": cfg["mu_beta"], "tau_beta": cfg["tau_beta"], "rho": cfg["rho"], "a_omega": cfg["a_omega"],
             "b_omega": cfg["b_omega"], "P": st.Diagonal(torch.ones(n)), "tau_y": cfg["tau0"],
             "a_tau": cfg["a_tau"], "b_tau": cfg["b_tau"], "B": g.make(X, theta, omega, k0).numpy()}
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "B"}), precision=ScaledMatrix("P", "tau_y")),
        Normal("beta", mean=MixtureParameterVector("mu_beta", "alloc_beta"),
               precision=MixtureParameterMatrix("tau_beta", "alloc_beta"), n_active="n_basis"),
        Poisson("n_basis", rate="rho"),
        Uniform("theta", domain_response_lower=lo, domain_response_upper=hi, n_active="n_basis"),
        Gamma("omega", shape="a_omega", rate="b_omega", n_active="n_basis"),
        Gamma("tau_y", shape="a_tau", rate="b_tau"),
    ])
    walk = dict(state_update_function=g.move, vector_state_update_function=g.move_vec, active_count="n_basis")
    samplers = [
        ManifoldMALA("beta", mdl, step=cfg["step_mmala"], active_count="n_basis"),
        RandomWalkLoop("theta", mdl, step=cfg["step_theta"], domain_limits=np.asarray([[lo, hi]]),
                       updated_names=["theta", "B"], **walk),
        RandomWalkLoop("omega", mdl, step=cfg["step_omega"], domain_limits=np.asarray([cfg["omega_rw_limits"]]),
                       updated_names=["omega", "B"], **walk),
        ReversibleJump("n_basis", mdl, associated_params=["theta", "omega"], n_max=p, state_birth_function=g.birth,
                       state_death_function=g.death,
                       matching_params={"variable": "beta", "matrix": "B", "scale": 1.0, "limits": [lo, hi]}),
        NormalGamma("tau_y", mdl),
    ]
    return MCMC(state, samplers, mdl, n_burn=cfg["n_burn"], n_iter=cfg["n_iter"], n_chains=cfg["n_chains"], seed=0,
                store_names=["n_basis", "beta", "theta", "omega", "tau_y"], device=device)


def outputs(result) -> dict:
    """The fit's count and tau_y as (chains, draws, 2) floats (``x``, the
    fixed-dimension quantities whose mean ESS the benchmark reports), the count
    as (chains, draws) integers (``k``), tau_y (chains, draws), the padded
    beta, theta and omega (chains, draws, n_max), and its log posterior
    (chains, draws)."""
    st = result.store
    k, tau = st["n_basis"][..., 0, 0], st["tau_y"][..., 0, 0]
    return {"x": torch.stack([k.to(torch.float32), tau], -1), "k": k, "tau": tau, "beta": st["beta"][..., 0],
            "theta": st["theta"][..., 0, :], "omega": st["omega"][..., 0, :], "log_post": result.log_post}


def altered(mcmc, result) -> None:
    """The first coefficient of one stored draw, active in every draw (k >= 1),
    moved 0.25 away from the prior's mean where it is produced, its log
    posterior not: the likelihood and the prior it reads always change."""
    b = result.store["beta"][3, 7, 0]
    b += torch.where(b >= 0.0, 0.25, -0.25)
