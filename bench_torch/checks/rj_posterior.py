"""The check of a reversible-jump regression fit: a posterior with no closed
form over a state of varying dimension. Each checked fit is held against the
plain reference (``reference/rj_regression.py``), in float64 after the window
has closed:

- ``lp_gap``: the largest relative gap, over every stored draw, between the
  program's log posterior and the reference's joint log density of the stored
  state (k, beta, theta, omega, tau_y): |lp - lp_ref| / max(|lp_ref|, 1). It
  catches a stored value altered where it is produced and a log posterior
  computed wrongly or in a lower precision than float32.
- ``count_z`` and ``tau_z``: the largest |z| of the count's (of tau_y's)
  posterior mean and variance against the reference sampler's, each
  difference over the combined Monte Carlo standard error of the two. Each
  error comes from the spread of the chains' own means (of the draws; for the
  variance, of their squared deviations from the pooled mean) over the square
  root of the chains: the chains are independent, so this holds whatever
  each chain's autocorrelation, where the multi-chain ESS understated the
  error of tau_y's variance, whose slow part follows the knots. They catch
  chains that do not move, chains left out, and draws from another
  distribution.

The reference sampler runs once for each distinct checked dataset, on the
card: ``ref_chains`` chains, ``ref_burn`` sweeps of burn-in and ``ref_sweeps``
stored sweeps, from the configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

NUMBERS = ("lp_gap", "count_z", "tau_z")
SEED = 20240611  # the reference sampler's: one fixed stream a dataset


@dataclass
class Posterior:
    """The reference module, its problem, its burn-in, and the sampler's
    moments of the count and tau_y (mean, variance and their standard errors)."""

    module: object
    problem: object
    burn: int
    moments: dict


def summary(draws: torch.Tensor) -> tuple:
    """(mean, variance, se of the mean, se of the variance) of (chains, draws),
    the errors from the spread of the chains' means."""
    x = draws.to(torch.float64)
    mean = torch.mean(x)
    dev2 = (x - mean) ** 2
    root = math.sqrt(x.shape[0])
    return (float(mean), float(torch.mean(dev2)), float(torch.std(torch.mean(x, 1)) / root),
            float(torch.std(torch.mean(dev2, 1)) / root))


def z_score(got: tuple, want: tuple) -> float:
    """The larger |z| of the mean and the variance, on the combined standard error."""
    z_mean = abs(got[0] - want[0]) / math.hypot(got[2], want[2])
    z_var = abs(got[1] - want[1]) / math.hypot(got[3], want[3])
    return math.nan if math.isnan(z_mean) or math.isnan(z_var) else max(z_mean, z_var)


def problem_of(module, cfg: dict, data: dict, device):
    lo, hi = cfg["theta_limits"]
    return module.Problem(data["X"].to(device, torch.float64), data["y"].to(device, torch.float64), cfg["n_max"],
                          cfg["rho"], lo, hi, cfg["mu_beta"], cfg["tau_beta"], cfg["a_omega"], cfg["b_omega"],
                          cfg["a_tau"], cfg["b_tau"])


def reference_for(cell, cfg: dict, data: dict, device) -> Posterior:
    """The reference sampler's float64 posterior moments for one dataset."""
    module = cell.reference
    problem = problem_of(module, cfg, data, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    d = module.sample(problem, cfg["ref_chains"], cfg["ref_burn"], cfg["ref_sweeps"], gen)
    return Posterior(module, problem, cfg["ref_burn"], {name: summary(d[name]) for name in ("k", "tau")})


def readings(outputs: dict, reference: Posterior, device) -> dict:
    """The numbers compared for one fit's outputs (the model's ``outputs``)."""
    state = (outputs[name].to(device) for name in ("k", "beta", "theta", "omega", "tau"))
    lp_ref = reference.module.log_density(reference.problem, *state)
    lp = outputs["log_post"].reshape(-1).to(lp_ref.device, torch.float64)
    gap = float(torch.max(torch.abs(lp - lp_ref) / torch.clamp(torch.abs(lp_ref), min=1.0)))
    z = {name: z_score(summary(outputs[name].to(device)), reference.moments[name]) for name in ("k", "tau")}
    return {"lp_gap": gap, "count_z": z["k"], "tau_z": z["tau"]}


def control_outputs(reference: Posterior, precision: str, chains: int, keep: int,
                    generator: torch.Generator) -> dict:
    """The model's outputs for the reference sampler's draws in ``precision``
    (``chains`` chains, ``keep`` stored sweeps after the reference's burn-in),
    their log density computed in it."""
    module, problem = reference.module, reference.problem
    d = module.sample(problem, chains, reference.burn, keep, generator, precision, full=True)
    lp = module.log_density(problem, d["k"], d["beta"], d["theta"], d["omega"], d["tau"], precision)
    k, tau = d["k"], d["tau"].to(torch.float32)
    out = {name: d[name].to(torch.float32) for name in ("beta", "theta", "omega")}
    return {"x": torch.stack([k.to(torch.float32), tau], -1), "k": k, "tau": tau, **out,
            "log_post": lp.reshape(chains, keep)}
