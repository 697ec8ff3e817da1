"""Bayesian linear regression of the reference's example 3, built in the program.

y ~ N(X beta, (tau I)^-1), beta ~ N(0, (lam I)^-1), Gamma priors on tau and
lam, beta0 = 0, tau0 and lam0 from the configuration. Data as the example
makes it: X = [1, x] with x n_obs sorted uniform draws on [0, 1),
y = X beta_true + N(0, noise_sd^2). Samplers: NormalNormal on beta,
NormalGamma on tau and on lam; all stored.
"""

from __future__ import annotations

import torch


def make_data(cfg: dict, generator: torch.Generator, device) -> dict:
    """X and y from the seed's generator, on ``device``, in two draws."""
    f32 = dict(dtype=torch.float32, device=device)
    n = cfg["n_obs"]
    x = torch.sort(torch.rand(n, generator=generator, **f32)).values
    X = torch.stack([torch.ones(n, **f32), x], 1)
    y = X @ torch.tensor(cfg["beta_true"], **f32) + cfg["noise_sd"] * torch.randn(n, generator=generator, **f32)
    return {"X": X, "y": y}


def build(cfg: dict, data: dict, device):
    """The program's MCMC for this configuration, as a user writes it."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    n, p = cfg["n_obs"], len(cfg["beta_true"])
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P_tau", "tau")),
        Normal("beta", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("tau", shape="a_tau", rate="b_tau"),
        Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ])
    f32 = dict(dtype=torch.float32, device=device)
    state = {"y": data["y"], "X": data["X"], "beta": torch.zeros(p, **f32), "P_tau": st.Diagonal(torch.ones(n, **f32)),
             "tau": cfg["tau0"], "P_lambda": st.Diagonal(torch.ones(p, **f32)), "mu": torch.zeros(p, **f32),
             "lambda": cfg["lam0"], "a_tau": cfg["a_tau"], "b_tau": cfg["b_tau"], "a_lambda": cfg["a_lam"],
             "b_lambda": cfg["b_lam"]}
    samplers = [NormalNormal("beta", mdl), NormalGamma("tau", mdl), NormalGamma("lambda", mdl)]
    return MCMC(state, samplers, mdl, n_burn=cfg["n_burn"], n_iter=cfg["n_iter"], n_chains=cfg["n_chains"], seed=0,
                device=device)


def set_data(mcmc, data: dict) -> None:
    """Give an MCMC built by :func:`build` new data (a new fit's X and y)."""
    mcmc.data["X"] = data["X"]
    mcmc.data["y"] = data["y"]


def outputs(result) -> dict:
    """The fit's draws as (chains, draws, k) tensors, and its log posterior (chains, draws)."""
    st = result.store
    return {"x": st["beta"][..., 0], "lam": st["lambda"][..., 0, 0, None], "tau": st["tau"][..., 0, 0, None],
            "log_post": result.log_post}


def problem(cfg: dict, data: dict) -> dict:
    """The fields of the reference's ``Problem`` for this fit's posterior."""
    X = data["X"].to(torch.float64)
    n, p = X.shape
    f64 = dict(dtype=torch.float64, device=X.device)
    return dict(y=data["y"], A=X, d=torch.ones(n, **f64), P=torch.eye(p, **f64), mu=torch.zeros(p, **f64),
                a_lam=cfg["a_lam"], b_lam=cfg["b_lam"], a_tau=cfg["a_tau"], b_tau=cfg["b_tau"])
