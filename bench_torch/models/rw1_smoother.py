"""The GMRF smoother of the reference's example 4, built in the program.

y = sin(s/20) + 2 cos(s/12) + 2 + N(0, noise_sd^2) at n_time points over
[0, t_end]; b ~ N(0, (lam P)^-1) with P the first-order random-walk precision
over s plus a ridge on P[0, 0]; Gamma priors on lam and tau. Samplers:
NormalNormal on b, NormalGamma on lam and on tau; b, lam and tau stored.
"""

from __future__ import annotations

import torch


def make_data(cfg: dict, generator: torch.Generator, device) -> dict:
    """The observations from the seed's generator, on ``device``, and P's bands
    (float32, as the program's ``gmrf.precision_irregular`` lays them out)."""
    f32 = dict(dtype=torch.float32, device=device)
    p = cfg["n_time"]
    s = torch.linspace(0.0, cfg["t_end"], p, **f32)
    noise = torch.randn(p, generator=generator, **f32)
    y = torch.sin(s / 20.0) + 2.0 * torch.cos(s / 12.0) + 2.0 + cfg["noise_sd"] * noise
    dr = 1.0 / torch.diff(s)
    diag = torch.cat([dr[:1], dr[:-1] + dr[1:], dr[-1:]])
    diag[0] += cfg["ridge"]
    off = torch.cat([-dr, torch.zeros(1, **f32)])
    return {"y": y, "bands": torch.stack([diag, off])}


def build(cfg: dict, data: dict, device):
    """The program's MCMC for this configuration, as a user writes it."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    p = cfg["n_time"]
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("lambda", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    f32 = dict(dtype=torch.float32, device=device)
    state = {"y": data["y"], "b": data["y"].clone(), "mu": torch.zeros(p, **f32), "lambda": cfg["lam0"],
             "P_lambda": st.Banded(data["bands"]), "a_lam": cfg["a_lam"], "b_lam": cfg["b_lam"], "tau": cfg["tau0"],
             "P_tau": st.Diagonal(torch.ones(p, **f32)), "a_tau": cfg["a_tau"], "b_tau": cfg["b_tau"]}
    samplers = [NormalNormal("b", mdl), NormalGamma("lambda", mdl), NormalGamma("tau", mdl)]
    return MCMC(state, samplers, mdl, n_burn=cfg["n_burn"], n_iter=cfg["n_iter"], n_chains=cfg["n_chains"], seed=0,
                store_names=["b", "tau", "lambda"], device=device)


def set_data(mcmc, data: dict) -> None:
    """Give an MCMC built by :func:`build` new observations (a new fit's data)."""
    mcmc.data["y"] = data["y"]
    mcmc.initial_chain_state["b"] = data["y"].clone()


def outputs(result) -> dict:
    """The fit's draws as (chains, draws, k) tensors, and its log posterior (chains, draws)."""
    st = result.store
    return {"x": st["b"][..., 0], "lam": st["lambda"][..., 0, 0, None], "tau": st["tau"][..., 0, 0, None],
            "log_post": result.log_post}


def problem(cfg: dict, data: dict) -> dict:
    """The fields of the reference's ``Problem`` for this fit's posterior."""
    bands = data["bands"].to(torch.float64)
    p = bands.shape[1]
    P = torch.diag(bands[0]) + torch.diag(bands[1, :-1], 1) + torch.diag(bands[1, :-1], -1)
    zeros = torch.zeros(p, dtype=torch.float64, device=bands.device)
    return dict(y=data["y"], A=None, d=torch.ones_like(zeros), P=P, mu=zeros, a_lam=cfg["a_lam"], b_lam=cfg["b_lam"],
                a_tau=cfg["a_tau"], b_tau=cfg["b_tau"])
