"""The comparison that decides ``correct``.

Each checked fit is held against the plain reference (``reference/``), run in
float64 after the window has closed:

- ``lp_gap``: the largest relative gap, over every stored draw of the fit,
  between the program's log posterior and the reference's joint log density at
  the same draw: |lp - lp_ref| / max(|lp_ref|, 1). It catches a draw altered
  where it is produced (the store kernel included) and a log posterior
  computed wrongly.
- ``moment_z``: the largest |z| over every coordinate of the latent, lam and
  tau, of the fit's posterior mean and variance against the reference's exact
  ones, each in units of its Monte Carlo standard error (the sample sd over
  the square root of the benchmark's multi-chain ESS; for the variance, of
  the squared deviations). It catches chains that do not move, chains left
  out, and draws from another distribution.

A number that is not a number fails.

This is the check of a configuration that names none. One that names its own
(``checks/<name>.py``) has what this module has, ``NUMBERS``,
:func:`reference_for`, :func:`readings` and :func:`control_outputs`, and is
judged by :func:`passes` and :func:`limits` from here.
"""

from __future__ import annotations

import math

import torch

from bench_torch.ess import ess_per_column

NUMBERS = ("lp_gap", "moment_z")


def moment_z(draws: torch.Tensor, mean_ref: torch.Tensor, var_ref: torch.Tensor, chunk: int = 16) -> float:
    """Largest |z| of the column means and variances of (chains, draws, k) against
    the reference's, ``chunk`` columns at a time."""
    worst = 0.0
    for i in range(0, draws.shape[2], chunk):
        x = draws[:, :, i : i + chunk].to(torch.float64)
        mean = torch.mean(x, (0, 1))
        dev2 = (x - mean) ** 2
        var = torch.mean(dev2, (0, 1))
        del x
        z_mean = (mean - mean_ref[i : i + chunk]) / torch.sqrt(var / ess_per_column(draws[:, :, i : i + chunk]))
        se_var = torch.std(dev2, (0, 1)) / torch.sqrt(ess_per_column(dev2.to(torch.float32)))
        z_var = (var - var_ref[i : i + chunk]) / se_var
        z = float(torch.max(torch.cat([torch.abs(z_mean), torch.abs(z_var)])))
        if math.isnan(z):
            return math.nan
        worst = max(worst, z)
    return worst


def lp_gap(outputs: dict, reference) -> float:
    """Largest relative gap between the fit's log posterior and the reference's."""
    p = outputs["x"].shape[2]
    lp_ref = reference.log_density(outputs["x"].reshape(-1, p), outputs["lam"].reshape(-1),
                                   outputs["tau"].reshape(-1)).to(torch.float64)
    lp = outputs["log_post"].reshape(-1).to(lp_ref.device, torch.float64)
    return float(torch.max(torch.abs(lp - lp_ref) / torch.clamp(torch.abs(lp_ref), min=1.0)))


def reference_for(cell, cfg: dict, data: dict, device):
    """The float64 plain reference of one fit's posterior: the reference's
    ``Problem`` of the model's fields."""
    return cell.reference.Reference(cell.reference.Problem(**cell.model.problem(cfg, data)), "float64", device)


def readings(outputs: dict, reference, device) -> dict:
    """The numbers compared for one fit's outputs ({"x", "lam", "tau": (chains,
    draws, k), "log_post": (chains, draws)}) against a float64 reference."""
    moments = reference.moments()
    worst = 0.0
    for name in ("x", "lam", "tau"):
        mean_ref, var_ref = (m.to(device, torch.float64) for m in moments[name])
        z = moment_z(outputs[name].to(device), mean_ref, var_ref)
        worst = z if math.isnan(z) else max(worst, z)
        if math.isnan(worst):
            break
    return {"lp_gap": lp_gap(outputs, reference), "moment_z": worst}


def control_outputs(reference, precision: str, chains: int, keep: int, generator: torch.Generator) -> dict:
    """The model's outputs for exact posterior draws made by the reference in
    ``precision``, their log density computed in it."""
    put = reference if precision == "float64" else reference.at(precision)
    d = put.sample(chains * keep, generator)
    lp = put.log_density(d["x"], d["lam"], d["tau"])
    out = {k: d[k].reshape(chains, keep, -1).to(torch.float32) for k in ("x", "lam", "tau")}
    return {**out, "log_post": lp.reshape(chains, keep)}


def passes(value: float, limit: float) -> bool:
    return value <= limit  # False for NaN


def limits(config: dict, numbers=NUMBERS) -> dict:
    """The limit of each of ``numbers`` (the configuration's check's), as the
    configuration states it."""
    return {k: float(config["limits"][k]) for k in numbers}
