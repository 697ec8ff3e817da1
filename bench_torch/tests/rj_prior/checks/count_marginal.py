"""The check of a reversible-jump fit whose posterior is known through the
count's marginal alone (the prior-recovery model: no closed form for the
variable-dimension state's moments, but the count's is the [1, n_max]-truncated
Poisson). Each checked fit is held against the plain reference
(``reference/rj_prior.py``), in float64 after the window has closed:

- ``lp_gap``: the largest relative gap, over every stored draw, between the
  program's log posterior and the reference's joint log density of the stored
  state (k, beta, theta, omega): |lp - lp_ref| / max(|lp_ref|, 1). It catches
  a stored value altered where it is produced and a log posterior computed
  wrongly or in a lower precision.
- ``count_z``: the largest |z| of the count's posterior mean and variance
  against the exact marginal's, in Monte Carlo standard errors
  (``check.moment_z``). It catches chains that do not move, chains left out,
  and counts drawn from another distribution.
"""

from __future__ import annotations

import torch

from bench_torch import check

NUMBERS = ("lp_gap", "count_z")


def reference_for(cell, cfg: dict, data: dict, device):
    """The float64 prior of the configuration (the data do not enter it)."""
    return cell.reference.Reference(cell.reference.Prior.of(cfg), "float64", device)


def readings(outputs: dict, reference, device) -> dict:
    """The numbers compared for one fit's outputs (the model's ``outputs``)."""
    lp_ref = reference.log_density(*(outputs[k].to(device) for k in ("k", "beta", "theta", "omega")))
    lp = outputs["log_post"].reshape(-1).to(lp_ref.device, torch.float64)
    gap = float(torch.max(torch.abs(lp - lp_ref) / torch.clamp(torch.abs(lp_ref), min=1.0)))
    mean, var = (torch.tensor([v], dtype=torch.float64, device=device) for v in reference.count_moments())
    return {"lp_gap": gap, "count_z": check.moment_z(outputs["x"].to(device), mean, var)}


def control_outputs(reference, precision: str, chains: int, keep: int, generator: torch.Generator) -> dict:
    """The model's outputs for exact draws of the prior made by the reference in
    ``precision``, their log density computed in it."""
    put = reference if precision == "float64" else reference.at(precision)
    d = put.sample(chains * keep, generator)
    lp = put.log_density(d["k"], d["beta"], d["theta"], d["omega"])
    k = d["k"].reshape(chains, keep)
    out = {name: d[name].reshape(chains, keep, -1).to(torch.float32) for name in ("beta", "theta", "omega")}
    return {"x": k[..., None].to(torch.float32), "k": k, **out, "log_post": lp.reshape(chains, keep)}
