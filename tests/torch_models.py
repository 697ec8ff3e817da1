"""Three models the port's fused engines match, built as a user writes them, at
any size: reference example 4's GMRF smoother (``fused_smoother_spectral``),
example 3's linear regression (``fused_linreg``) and the reversible-jump
knot-basis regression (``fused_rj``)."""

import torch

F32 = dict(dtype=torch.float32)


def smoother_mcmc(seed, p=12, n_chains=8, n_burn=4, n_iter=6, device="cpu"):
    """A GMRF smoother: RW1 prior over ``p`` points, y = sin(i/3) + N(0, 0.09)."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    gen = torch.Generator().manual_seed(seed)
    y = torch.sin(torch.arange(p, **F32) / 3.0) + 0.3 * torch.randn(p, generator=gen, **F32)
    diag = torch.full((p,), 2.0, **F32)
    diag[0], diag[-1] = 1.001, 1.0
    bands = torch.stack([diag, torch.cat([torch.full((p - 1,), -1.0, **F32), torch.zeros(1, **F32)])])
    y, bands = y.to(device), bands.to(device)
    f32 = dict(dtype=torch.float32, device=device)
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("lambda", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    state = {"y": y, "b": y.clone(), "mu": torch.zeros(p, **f32), "lambda": 10.0, "P_lambda": st.Banded(bands),
             "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0, "P_tau": st.Diagonal(torch.ones(p, **f32)), "a_tau": 1.0,
             "b_tau": 1.0}
    samplers = [NormalNormal("b", mdl), NormalGamma("lambda", mdl), NormalGamma("tau", mdl)]
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed, device=device)


def linreg_mcmc(seed, n=20, n_chains=8, n_burn=4, n_iter=6, device="cpu"):
    """A linear regression: X = [1, x] with x sorted uniform, beta (2, 0.5), noise sd 0.1."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    p = 2
    gen = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, generator=gen, **F32)).values
    X = torch.stack([torch.ones(n, **F32), x], 1)
    y = X @ torch.tensor([2.0, 0.5], **F32) + 0.1 * torch.randn(n, generator=gen, **F32)
    X, y = X.to(device), y.to(device)
    f32 = dict(dtype=torch.float32, device=device)
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P_tau", "tau")),
        Normal("beta", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("tau", shape="a_tau", rate="b_tau"),
        Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ])
    state = {"y": y, "X": X, "beta": torch.zeros(p, **f32), "P_tau": st.Diagonal(torch.ones(n, **f32)), "tau": 1.0,
             "P_lambda": st.Diagonal(torch.ones(p, **f32)), "mu": torch.zeros(p, **f32), "lambda": 0.01,
             "a_tau": 1e-3, "b_tau": 1e-3, "a_lambda": 1e-3, "b_lambda": 1e-3}
    samplers = [NormalNormal("beta", mdl), NormalGamma("tau", mdl), NormalGamma("lambda", mdl)]
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed, device=device)


def rj_regression_mcmc(seed, n_max=6, n_data=20, n_chains=8, n_burn=4, n_iter=6, step_theta=0.1, step_omega=0.1,
                       rho=8.0, store=("n_basis", "beta", "theta", "omega", "tau_y"), device="cpu"):
    """The reversible-jump knot-basis regression (``fused_rj``): the reference's
    test_reversible_jump.py fixture with y ~ N(B beta, (tau_y I)^-1), tau_y ~
    Gamma(2, 0.01). Data of the fixture's law from ``seed``: ``n_data`` sorted
    points on [-10, 10], y from 4 knots (widths 1, coefficients 2 N(0, 1)) with
    noise sd 0.1; four random starting knots (widths 1, coefficients 1), tau_y
    100. Returns the MCMC and its data (X, y as float64 numpy columns)."""
    import numpy as np

    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.basis import GaussianKernelBasis
    from openmcmc_tpu_torch.distributions import Gamma, Normal, Poisson, Uniform
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import (LinearCombination, MixtureParameterMatrix, MixtureParameterVector,
                                               ScaledMatrix)
    from openmcmc_tpu_torch.samplers import ManifoldMALA, NormalGamma, RandomWalkLoop, ReversibleJump

    g, rng = GaussianKernelBasis(), np.random.default_rng(seed)
    X = np.sort(rng.uniform(-10, 10, (n_data, 1)), axis=0)
    th_true, beta_true = rng.uniform(-10, 10, (1, 4)), 2.0 * rng.normal(size=(4, 1))
    y = np.exp(-0.5 * (X - th_true) ** 2) / np.sqrt(2 * np.pi) @ beta_true + 0.1 * rng.normal(size=(n_data, 1))
    k0 = min(4, n_max)
    theta = np.zeros((1, n_max)); theta[0, :k0] = rng.uniform(-10, 10, k0)
    omega = np.zeros((1, n_max)); omega[0, :k0] = 1.0
    beta = np.zeros((n_max, 1)); beta[:k0] = 1.0
    state = {"X": X, "y": y, "n_basis": np.array([[k0]], np.int32), "theta": theta, "omega": omega, "beta": beta,
             "alloc_beta": np.zeros((n_max, 1), np.int32), "mu_beta": 0.0, "tau_beta": 0.25, "rho": rho,
             "a_omega": 3.0, "b_omega": 2.0, "P": st.Diagonal(torch.ones(n_data)), "tau_y": 100.0, "a_tau": 2.0,
             "b_tau": 0.01, "B": g.make(X, theta, omega, k0).numpy()}
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "B"}), precision=ScaledMatrix("P", "tau_y")),
        Normal("beta", mean=MixtureParameterVector("mu_beta", "alloc_beta"),
               precision=MixtureParameterMatrix("tau_beta", "alloc_beta"), n_active="n_basis"),
        Poisson("n_basis", rate="rho"),
        Uniform("theta", domain_response_lower=-10.0, domain_response_upper=10.0, n_active="n_basis"),
        Gamma("omega", shape="a_omega", rate="b_omega", n_active="n_basis"),
        Gamma("tau_y", shape="a_tau", rate="b_tau"),
    ])
    walk = dict(state_update_function=g.move, vector_state_update_function=g.move_vec, active_count="n_basis")
    samplers = [
        ManifoldMALA("beta", mdl, step=0.5, active_count="n_basis"),
        RandomWalkLoop("theta", mdl, step=step_theta, domain_limits=np.asarray([[-10.0, 10.0]]),
                       updated_names=["theta", "B"], **walk),
        RandomWalkLoop("omega", mdl, step=step_omega, domain_limits=np.asarray([[0.5, 2.0]]),
                       updated_names=["omega", "B"], **walk),
        ReversibleJump("n_basis", mdl, associated_params=["theta", "omega"], n_max=n_max,
                       state_birth_function=g.birth, state_death_function=g.death,
                       matching_params={"variable": "beta", "matrix": "B", "scale": 1.0, "limits": [-10.0, 10.0]}),
        NormalGamma("tau_y", mdl),
    ]
    mcmc = MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed,
                store_names=list(store), device=device)
    return mcmc, {"X": X[:, 0], "y": y[:, 0]}
