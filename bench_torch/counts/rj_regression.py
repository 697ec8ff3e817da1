"""Float32 operations and bytes of one ``rj_regression`` fit, from what the fit
drew: the likelihood variant of the reversible-jump sweep (``csrc/rj.cu``),
counted at the active size as ``chip_smoke.py``'s ``rj_flop_per_sweep(k,
n_max, n_data, lik=True)`` counts it (transcendentals, square roots and
divisions one each, Philox's integer rounds not counted). Its work follows the
count of active knots, so each stored sweep's count stands for its share of
the fit's sweeps. The n operations of each accepted residual update, which
``rj_flop`` adds from a run's accept counts, are left out."""

from __future__ import annotations

import numpy as np
import torch


def chol_flop(m):
    """A lower-triangle Cholesky of m x m: (m^3 - m) / 3 multiply-adds, m (m - 1) / 2
    divisions, 5 a pivot."""
    return (m ** 3 - m) / 3 + m * (m - 1) / 2 + 5 * m


def flop_per_sweep(k, n_max: int, n_data: int):
    """One chain's sweep from k active knots (k may be an array): the basis, the
    Gram, two model densities and the accept; the birth at its probability (certain
    at k <= 1, impossible at n_max, else one half) or the death; then the
    likelihood's terms: the residual, the mMALA step with its Fisher metric and
    factorization, the 2 k column walks with the running residual, the move's
    quadratics, the two log likelihoods, and tau's Gamma round with the log
    posterior."""
    k = np.asarray(k, dtype=np.float64)
    n = float(n_data)
    p_birth = np.where(k <= 1, 1.0, np.where(k >= n_max, 0.0, 0.5))
    birth = (70 + 8 * n + 2 * k * n + 2 * n + 2 * k + 1 + 2 * chol_flop(k + 1) + 4 * k * n + 2 * n
             + 2 * (k + 1) ** 2 + 129 + 23)
    death = 12 + 3 * k + 2 * k * k + 2 * chol_flop(k) + 2 * k * k + 51 + 6
    flop = 8 * k * n + k * (k + 1) * n + 30 * k + 11 + p_birth * birth + (1 - p_birth) * death
    return flop + (2 * k * n + n + k * (k + 1) * n + 2 * k * n + 4 * k + k * (k + 1) / 2 + k + chol_flop(k)
                   + 3 * k * k + 43 * k + 3 + 2 * k * k + 2 * k * n + 4 * n + 10 * k + 7 + 383 * k + 28 * k * n
                   + 2 * n + p_birth * (2 * k * n + 6 * n) + (1 - p_birth) * (2 * (k - 1) * n + 3 * n) + 10 + 80)


def fit_drawn(cfg: dict, outputs: dict) -> tuple:
    """(flop, bytes) of one fit from its stored counts (``outputs["k"]``,
    chains x stored sweeps): each stored sweep's work at its count, times the
    fit's sweeps over its stored ones. Bytes count each input read once and
    each output written once: X, y and the initial rows (beta, theta, omega, k,
    tau_y, six counters) in; the count, log posterior, six counters, tau_y and
    the padded beta, theta, omega of every stored sweep out."""
    k = outputs["k"]
    n_max, n_data = cfg["n_max"], cfg["n_data"]
    per_k = torch.as_tensor(flop_per_sweep(np.arange(n_max + 1), n_max, n_data), dtype=torch.float64,
                            device=k.device)
    stored = float(torch.bincount(k.reshape(-1).long(), minlength=n_max + 1).to(torch.float64) @ per_k)
    chains, keep = k.shape
    flop = stored * (cfg["n_burn"] + cfg["n_iter"]) / keep
    n_bytes = 4 * (2 * n_data + chains * (3 * n_max + 8) + chains * keep * (9 + 3 * n_max))
    return flop, float(n_bytes)
