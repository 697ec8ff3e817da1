"""Convergence diagnostics: effective sample size, split-R-hat, summaries (port of
``openmcmc_tpu/diagnostics.py``).

Conventions follow Vehtari et al. 2021 / Stan without rank-normalization:
multi-chain ESS with Geyer's initial positive and monotone sequence truncation,
split-R-hat on half chains. Draws are (n_chains, n_iter) for a scalar quantity,
or (n_chains, n_iter, ...); every trailing quantity is computed at once (one
batched FFT for ESS) on the draws' device.
"""

from __future__ import annotations

import torch


def _ess_columns(draws: torch.Tensor, allow_super_efficiency: bool = False) -> torch.Tensor:
    """ESS of each column of (m, n, k) draws -> (k,)."""
    m, n = draws.shape[0], draws.shape[1]
    xc = draws - torch.mean(draws, dim=1, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=1)  # zero-padded: no circular wrap
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=1)[:, :n] / n  # (m, n, k)
    chain_mean = torch.mean(draws, dim=1)
    mean_var = torch.mean(acov[:, 0], dim=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + torch.var(chain_mean, dim=0, correction=1)
    rho = 1.0 - (mean_var - torch.mean(acov, dim=0)) / var_plus  # (n, k)
    rho[0] = 1.0
    n_pairs = n // 2
    pairs = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    positive = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    monotone = torch.cummin(torch.where(positive > 0, pairs, torch.zeros_like(pairs)), dim=0).values
    tau = -rho[0] + 2.0 * torch.sum(monotone * positive, dim=0)
    tau = torch.clamp(tau, min=1.0 / n)
    ess = m * n / tau
    total = torch.tensor(float(m * n), dtype=rho.dtype, device=rho.device)
    cap = total * torch.log10(total) if allow_super_efficiency else total
    return torch.minimum(ess, cap)


def effective_sample_size(draws, allow_super_efficiency: bool = False) -> torch.Tensor:
    """Multi-chain bulk ESS for a scalar quantity; draws: (n_chains, n_iter).

    ESS = m n / tau with tau from the combined-chain autocorrelations, capped at
    the draw count m n (or at m n log10(m n) with ``allow_super_efficiency``)."""
    draws = torch.as_tensor(draws, dtype=torch.float32)
    return _ess_columns(draws[:, :, None], allow_super_efficiency)[0]


def ess_per_param(draws, chunk_size: int = 0) -> torch.Tensor:
    """ESS over trailing parameter axes; draws: (n_chains, n_iter, ...) -> (...).

    ``chunk_size > 0`` bounds peak memory to that many quantities per batched FFT."""
    draws = torch.as_tensor(draws, dtype=torch.float32)
    m, n = draws.shape[0], draws.shape[1]
    flat = draws.reshape(m, n, -1)
    k = flat.shape[2]
    step = chunk_size if chunk_size and chunk_size < k else k
    out = torch.cat([_ess_columns(flat[:, :, i : i + step]) for i in range(0, k, step)])
    return out.reshape(draws.shape[2:])


def _split_rhat_columns(draws: torch.Tensor) -> torch.Tensor:
    """Split-R-hat of each column of (m, n, k) draws -> (k,)."""
    half = draws.shape[1] // 2
    split = torch.cat([draws[:, :half], draws[:, half : 2 * half]], dim=0)  # (2m, half, k)
    chain_mean = torch.mean(split, dim=1)
    chain_var = torch.var(split, dim=1, correction=1)
    W = torch.mean(chain_var, dim=0)
    B = half * torch.var(chain_mean, dim=0, correction=1)
    var_plus = (half - 1.0) / half * W + B / half
    return torch.sqrt(var_plus / W)


def split_rhat(draws) -> torch.Tensor:
    """Split-R-hat for a scalar quantity; draws: (n_chains, n_iter)."""
    draws = torch.as_tensor(draws, dtype=torch.float32)
    return _split_rhat_columns(draws[:, :, None])[0]


def rhat_per_param(draws) -> torch.Tensor:
    """Split-R-hat over trailing axes; draws: (n_chains, n_iter, ...) -> (...)."""
    draws = torch.as_tensor(draws, dtype=torch.float32)
    m, n = draws.shape[0], draws.shape[1]
    return _split_rhat_columns(draws.reshape(m, n, -1)).reshape(draws.shape[2:])


def _quantiles(flat: torch.Tensor, qs) -> list:
    """Linear-interpolation quantiles over axis 0 (numpy's and JAX's default) from
    one sort: ``torch.quantile`` refuses inputs above 2**24 elements, and a
    full-width store (8192 chains x 500 draws x p) is far above that."""
    n = flat.shape[0]
    srt = torch.sort(flat, dim=0).values
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(pos)
        hi, frac = min(lo + 1, n - 1), pos - lo
        out.append(srt[lo] * (1.0 - frac) + srt[hi] * frac)
    return out


def summary(draws) -> dict:
    """Posterior summary over (n_chains, n_iter, ...) draws: mean, sd (population),
    5/50/95 % quantiles (linear interpolation), ESS and split-R-hat, each (...)."""
    draws = torch.as_tensor(draws, dtype=torch.float32)
    flat = draws.reshape((-1,) + tuple(draws.shape[2:]))
    q05, q50, q95 = _quantiles(flat, (0.05, 0.5, 0.95))
    return {
        "mean": torch.mean(flat, dim=0),
        "sd": torch.std(flat, dim=0, correction=0),
        "q05": q05,
        "q50": q50,
        "q95": q95,
        "ess": ess_per_param(draws),
        "rhat": rhat_per_param(draws),
    }
