"""Two models the port's fused engines match, built as a user writes them, at
any size: reference example 4's GMRF smoother (``fused_smoother_spectral``)
and example 3's linear regression (``fused_linreg``)."""

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
