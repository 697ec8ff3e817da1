"""The benchmark's own multi-chain effective sample size.

A copy of ``openmcmc_tpu_torch/diagnostics.py``'s ``_ess_columns`` and
``ess_per_param``, kept here so that a change to the program cannot move the
yardstick: Vehtari et al. 2021 / Stan without rank-normalization, Geyer's
initial positive and monotone sequence, the estimate capped at the draw count.
``tests/test_ess.py`` holds it equal to the program's function.
"""

from __future__ import annotations

import torch


def ess_columns(draws: torch.Tensor) -> torch.Tensor:
    """ESS of each column of (m, n, k) draws -> (k,), capped at m n.

    The arithmetic of the program's ``_ess_columns``, with the draw axis moved
    last so that the FFTs run over contiguous rows."""
    m, n = draws.shape[0], draws.shape[1]
    x = draws.permute(0, 2, 1).contiguous()  # (m, k, n)
    xc = x - torch.mean(x, dim=2, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=2)  # zero-padded: no circular wrap
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=2)[:, :, :n] / n  # (m, k, n)
    chain_mean = torch.mean(x, dim=2)  # (m, k)
    mean_var = torch.mean(acov[:, :, 0], dim=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(chain_mean, dim=0, correction=1)
    rho = (1.0 - (mean_var[:, None] - torch.mean(acov, dim=0)) / var_plus[:, None]).T  # (n, k)
    rho[0] = 1.0
    n_pairs = n // 2
    pairs = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    positive = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    monotone = torch.cummin(torch.where(positive > 0, pairs, torch.zeros_like(pairs)), dim=0).values
    tau = -rho[0] + 2.0 * torch.sum(monotone * positive, dim=0)
    tau = torch.clamp(tau, min=1.0 / n)
    ess = m * n / tau
    total = torch.tensor(float(m * n), dtype=rho.dtype, device=rho.device)
    return torch.minimum(ess, total)


def ess_per_column(draws: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """ESS of each column of (m, n, k) float32 draws, ``chunk`` columns at a time
    (the FFTs' scratch is about six times the chunk's draws)."""
    draws = draws.to(torch.float32)
    k = draws.shape[2]
    return torch.cat([ess_columns(draws[:, :, i : i + chunk]) for i in range(0, k, chunk)])
